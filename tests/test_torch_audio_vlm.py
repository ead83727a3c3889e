"""The port's audio (whisper-base: encoder, cross attention, sinusoid
positions) and vlm (internvl2-26b: the patch projector) families vs the
JAX reference, on the CPU.

Here ``flash_attention_cuda`` takes its plain PyTorch path (the tensors lie
on the CPU); the CUDA kernel is held against that path on the card by
``chip_smoke.py``, at whisper's encoder (non-causal, S = 1500) and cross
(Sq = 416, Sk = 1500) shapes among them.  Inputs, the frames and patches
included, are made from a seed with numpy and handed to both sides;
weights are the reference's own, carried across by ``convert.lm_params``.

Oracles and tolerances (``test_torch_lm.py``'s):
  * the flash plain version, non-causal at Sq != Sk, vs
    ``flash_attention_pallas(interpret=True)``: atol 2e-5, rtol 1e-4;
  * layers and whole models in fp32: ``TOL`` = 1e-5 max abs, greedy
    tokens equal;
  * whole models in bf16, teacher-forced on the reference's tokens: within
    ``BF16_REL`` = 2e-2 of max |logit|.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as cb
from repro.kernels.flash_attention import flash_attention_pallas
from repro.models import attention as RA
from repro.models import layers as RL
from repro.models import model as rm
from repro.sharding import init_params
from repro_torch import convert
from repro_torch.configs import base as pcb
from repro_torch.kernels import flash_attention as FA
from repro_torch.launch import serve
from repro_torch.launch import specs as psp
from repro_torch.models import attention as PA
from repro_torch.models import layers as PL
from repro_torch.models import model as pm
from test_torch_lm import B, GEN, _close, _flash_inputs, _rel, _t
from test_torch_moe import (check_bf16, check_greedy_fp32, check_prefill_fp32,
                            lm_run)

WHISPER, VLM = "whisper-base", "internvl2-26b"


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Run this file's torch ops on one core: the other test workers share
    the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the flash kernel's plain version, non-causal, Sq != Sk
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(2, 4, 2, 52, 188, 64, 64),
                                   (1, 2, 2, 150, 150, 32, 32),
                                   (2, 4, 4, 200, 75, 16, 16)], ids=str)
def test_flash_plain_noncausal_vs_pallas(shape):
    """The encoder's (Sq = Sk, no multiple of a block) and the cross
    attention's (Sq < Sk, and Sq > Sk) non-causal calls: every query sees
    every key, so no alignment question arises (ROADMAP R4)."""
    q, k, v = _flash_inputs(shape)
    want = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=False, bq=128,
                                  bk=128, interpret=True)
    got = FA.flash_attention_cuda(_t(q), _t(k), _t(v), causal=False)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=1e-4)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("S,d,offset", [(24, 64, 0), (1500, 512, 0),
                                        (1, 512, 447), (448, 64, 0)])
def test_sinusoid_pos_emb_matches_reference(S, d, offset):
    _close(PL.sinusoid_pos_emb(S, d, offset),
           RL.sinusoid_pos_emb(S, d, offset))


def test_norms_match_reference():
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(2, 9, 4, 16)) * 3 + 1).astype(np.float32)
    w, b = (rng.normal(size=(16,)).astype(np.float32) for _ in range(2))
    wh = rng.normal(size=(4, 16)).astype(np.float32)
    _close(PL.group_norm_heads(_t(x), _t(wh)),
           RL.group_norm_heads(jnp.asarray(x), jnp.asarray(wh)))
    _close(PL.layer_norm(_t(x), _t(w), _t(b)),
           RL.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    got = PL.layer_norm(_t(x).bfloat16(), _t(w), _t(b))
    assert got.dtype == torch.bfloat16
    assert _rel(RL.layer_norm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w),
                              jnp.asarray(b)), got) < 1e-2


@pytest.fixture(scope="module")
def whisper():
    cfg = cb.smoke(WHISPER)
    params = init_params(rm.param_specs(cfg), jax.random.PRNGKey(0),
                         jnp.float32)
    return cfg, params, convert.lm_params(pcb.smoke(WHISPER),
                                          jax.tree.map(np.asarray, params))


@pytest.mark.parametrize("S", [1, 7, 32])
def test_cross_memory_and_fwd_match_reference(whisper, S):
    cfg, params, lm = whisper
    rp = jax.tree.map(lambda a: a[1], params["blocks"]["cross"])
    pp = lm.blocks[1]["cross"]
    rng = np.random.default_rng(S)
    mem = rng.normal(size=(B, cfg.encoder_len, cfg.d_model)).astype(
        np.float32)
    x = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    kv_r = RA.cross_memory(rp, jnp.asarray(mem), cfg)
    kv = PA.cross_memory(pp, _t(mem), cfg)
    for key in ("k", "v"):
        _close(kv[key], kv_r[key])
    want = RA.cross_fwd(rp, jnp.asarray(x), kv_r, cfg)
    _close(PA.cross_fwd(pp, _t(x), kv, cfg), want)
    if S == 1:                      # decode's plain path, the same function
        _close(PA.cross_step(pp, _t(x), kv, cfg), want)


def test_encoder_layer_matches_reference(whisper):
    """One encoder layer: non-causal ``gqa_fwd`` (no RoPE), then the MLP."""
    cfg, params, lm = whisper
    ep = jax.tree.map(lambda a: a[0], params["encoder"])
    h = np.random.default_rng(4).normal(
        size=(B, cfg.encoder_len, cfg.d_model)).astype(np.float32)
    y_r, _ = RA.gqa_fwd(ep["attn"], jnp.asarray(h), cfg, theta=0.0,
                        causal=False)
    y, _ = PA.gqa_fwd(lm.encoder[0]["attn"], _t(h), cfg, theta=0.0,
                      causal=False)
    _close(y, y_r)
    want = jnp.asarray(h) + y_r
    want = want + rm._mlp_fwd(ep["mlp"], want, cfg)
    _close(lm.encoder[0](pcb.smoke(WHISPER), _t(h)), want)


# ---------------------------------------------------------------------------
# whole models: whisper (encoder, cross caches) and internvl2 (patches)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("S", [32, 416])
@pytest.mark.parametrize("arch", [WHISPER, VLM])
def test_prefill_and_greedy_decode_fp32_match_reference(arch, S):
    r = lm_run(arch, "fp32", S)
    check_prefill_fp32(r)
    check_greedy_fp32(r)
    if arch == WHISPER:
        assert {k[0] for k in r["port_cache"]} == {"dec", "cross"}


@pytest.mark.parametrize("S", [32, 416])
@pytest.mark.parametrize("arch", [WHISPER, VLM])
def test_bf16_teacher_forced_logits_match_reference(arch, S):
    check_bf16(lm_run(arch, "bf16", S))


def test_patches_replace_the_first_embeddings():
    """internvl2: the projected patches take the first n_patches positions;
    the prompt's tokens there change nothing, the later ones do."""
    cfg = pcb.smoke(VLM)
    g = torch.Generator().manual_seed(0)
    lm = pm.init(cfg, g, torch.float32)
    b = psp.make_batch(cfg, 16, B, g)
    assert b["patches"].shape == (B, cfg.n_patches, cfg.vit_dim)
    assert b["patches"].dtype == torch.bfloat16
    x = pm._inject_inputs(lm, cfg, b)
    other = dict(b, tokens=b["tokens"].clone())
    other["tokens"][:, :cfg.n_patches] += 1
    torch.testing.assert_close(pm._inject_inputs(lm, cfg, other), x)
    other["tokens"][:, cfg.n_patches] += 1
    assert not torch.equal(pm._inject_inputs(lm, cfg, other), x)


@pytest.mark.parametrize("arch", [WHISPER, VLM])
def test_run_lm_end_to_end(arch):
    r = lm_run(arch, "fp32", 32)
    toks = serve.run_lm(arch, device="cpu", params=r["lm"],
                        tokens=r["tokens"], inputs=r["inputs"], gen=GEN)
    np.testing.assert_array_equal(toks.numpy(), r["ref_toks"])


@pytest.mark.parametrize("arch", [WHISPER, VLM])
def test_run_lm_defaults(arch, capsys):
    toks = serve.run_lm(arch, device="cpu")
    assert tuple(toks.shape) == (2, 16)
    assert int(toks.min()) >= 0 and int(toks.max()) < 256
    serve.main(["--mode", "lm", "--arch", arch, "--device", "cpu"])
    assert f"[serve-lm] {arch}: generated 16x2 tokens" in \
        capsys.readouterr().out


@pytest.mark.parametrize("S", [8, 16])
@pytest.mark.parametrize("arch", [WHISPER, VLM])
def test_decode_matches_forward(arch, S):
    """prefill + one decode step == full forward at position S (the
    reference's ``test_decode_matches_forward``, on the port alone, bf16):
    the decoder's sinusoid at ``pos`` and the cross cache for whisper."""
    cfg = pcb.smoke(arch)
    g = torch.Generator().manual_seed(0)
    lm = pm.init(cfg, g)
    b = psp.make_batch(cfg, S, B, g)
    toks = b.pop("tokens")
    with torch.inference_mode():
        last, cache = serve.prefill_cache(lm, cfg, toks, S + 4, b)
        tok = torch.argmax(last, -1).to(torch.int32)[:, None]
        got, _ = pm.decode_step(lm, cfg, tok, S, cache)
        ref, _, _ = pm.forward(lm, cfg, dict(b, tokens=torch.cat([toks, tok],
                                                                 1)))
    assert _rel(ref[:, -1], got) < 2e-2
