"""The port's MoE family (DeepSeek-V2/V3: MLA attention, routed experts)
vs the JAX reference, on the CPU.

Here ``flash_attention_cuda`` takes its plain PyTorch path (the tensors lie
on the CPU); the CUDA kernel is held against that path on the card by
``chip_smoke.py``.  Inputs are made from a seed with numpy and handed to
both sides; weights are the reference's own (``init_params`` with a fixed
key), carried across by ``convert.lm_params``.  int8 experts come from
``quantize_expert_weights`` of bf16-drawn weights, as ``test_archs.py``
makes them: an int8 spec initialises to zeros on both sides.

Oracles and tolerances (``test_torch_lm.py``'s):
  * layers and whole models in fp32: ``TOL`` = 1e-5 max abs (the same
    math in the same type; only summation orders differ).  Greedy tokens
    equal.
  * whole models and layers in bf16: within ``BF16_REL`` = 2e-2 of
    max |output| (the two frameworks round bf16 intermediates at
    different places; the bf16 models are teacher-forced on the
    reference's tokens).
  * int8 experts: the port's int8 ``moe_fwd`` within 3e-2 of max |y| of
    the reference's int8 ``moe_fwd`` (``test_archs.py``'s bound between
    int8 and bf16 experts); the quantised matrices and scales equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as cb
from repro.launch import specs as rsp
from repro.models import attention as RA
from repro.models import model as rm
from repro.models import moe as RM
from repro.sharding import init_params
from repro_torch import convert
from repro_torch.configs import base as pcb
from repro_torch.kernels import flash_attention as FA
from repro_torch.launch import serve
from repro_torch.launch import specs as psp
from repro_torch.models import attention as PA
from repro_torch.models import layers as PL
from repro_torch.models import model as pm
from repro_torch.models import moe as PM
from repro_torch.models.params import init_params as p_init_params
from test_torch_lm import (B, BF16_REL, GEN, TOL, _close, _flat, _np,
                           _put_jax, _rel, _shapes, _t)

ARCHS = ["deepseek-v2-236b", "deepseek-v3-671b"]
INT8_REL = 3e-2


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Run this file's torch ops on one core: the other test workers share
    the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _x(cfg, S=32, seed=1, scale=1.0):
    return (np.random.default_rng(seed).normal(size=(B, S, cfg.d_model))
            * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# configs and specs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_copy_the_reference(arch):
    assert dataclasses.asdict(pcb.get(arch)) == \
        dataclasses.asdict(cb.get(arch))
    assert dataclasses.asdict(pcb.smoke(arch)) == \
        dataclasses.asdict(cb.smoke(arch))


@pytest.mark.parametrize("experts", ["bf16", "int8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_match_the_reference(arch, experts):
    cfg = cb.smoke(arch).replace(expert_weights_dtype=experts)
    pcfg = pcb.smoke(arch).replace(expert_weights_dtype=experts)
    assert _shapes(pm.param_specs(pcfg)) == _shapes(rm.param_specs(cfg))
    assert _shapes(pm.cache_specs(pcfg, 2, 9)) == \
        _shapes(rm.cache_specs(cfg, 2, 9))


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_specs_match_the_reference(arch):
    """The published widths (nothing allocated): every parameter, the
    ``prefix`` layers and V3's ``mtp`` head included, and the caches."""
    cfg, pcfg = cb.get(arch), pcb.get(arch)
    assert _shapes(pm.param_specs(pcfg)) == _shapes(rm.param_specs(cfg))
    assert _shapes(pm.cache_specs(pcfg, 8, 2080)) == \
        _shapes(rm.cache_specs(cfg, 8, 2080))


def test_flash_runs_the_smoke_mla_head_dims_padded():
    """The smoke config's MLA heads, (24, 16), are no pair the kernel is
    instantiated for: on the card the wrapper zero-pads them to (32, 32)
    and keeps the scale at 24^-1/2, which gives the unpadded function."""
    cfg = pcb.smoke("deepseek-v2-236b")
    D = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    Dv = cfg.v_head_dim
    assert (D, Dv) == (24, 16)
    assert (D, Dv) not in FA.supported_head_dims()
    assert FA.padded_head_dims(D, Dv) == (32, 32)
    assert FA.padded_head_dims(192, 128) == (192, 128)
    assert FA.padded_head_dims(240, 240) == (240, 240)
    rng = np.random.default_rng(0)
    q, k = (_t(rng.normal(size=(2, 4, 40, D)).astype(np.float32))
            for _ in range(2))
    v = _t(rng.normal(size=(2, 4, 40, Dv)).astype(np.float32))
    want = FA.flash_attention_plain(q, k, v)
    pad = torch.nn.functional.pad
    got = FA.flash_attention_plain(pad(q, (0, 8)), pad(k, (0, 8)),
                                   pad(v, (0, 16)), scale=D ** -0.5)
    _close(got[..., :Dv], want)


# ---------------------------------------------------------------------------
# MLA, fp32, the reference's weights
# ---------------------------------------------------------------------------
def _ref_params(cfg, dtype=jnp.float32, seed=0):
    return init_params(rm.param_specs(cfg), jax.random.PRNGKey(seed), dtype)


@pytest.fixture(scope="module")
def smoke_models():
    """{arch: (cfg, reference params, port LM)} in fp32."""
    out = {}
    for arch in ARCHS:
        cfg = cb.smoke(arch)
        params = _ref_params(cfg)
        out[arch] = (cfg, params, convert.lm_params(
            pcb.smoke(arch), jax.tree.map(np.asarray, params)))
    return out


def _mla_cache_np(c_r, T):
    """The reference's prefill cache in a T-long cache (empty slots at
    position 1 << 30)."""
    out = {}
    for key, a in c_r.items():
        a = np.asarray(a)
        full = np.zeros((a.shape[0], T) + a.shape[2:], a.dtype)
        if key == "pos":
            full[:] = 1 << 30
        full[:, :a.shape[1]] = a
        out[key] = full
    return out


@pytest.mark.parametrize("absorb", [True, False])
@pytest.mark.parametrize("where", ["prefix", "block"])
def test_mla_fwd_and_step_match_reference(smoke_models, where, absorb):
    cfg, params, lm = smoke_models["deepseek-v3-671b"]
    if where == "prefix":
        rp, pp = params["prefix"]["l0"]["attn"], lm.prefix["l0"]["attn"]
    else:
        rp = jax.tree.map(lambda a: a[1], params["blocks"]["attn"])
        pp = lm.blocks[1]["attn"]
    x = _x(cfg)
    y_r, c_r = RA.mla_fwd(rp, jnp.asarray(x), cfg, want_cache=True)
    y, c = PA.mla_fwd(pp, _t(x), cfg, want_cache=True)
    _close(y, y_r)
    assert c.keys() == c_r.keys()
    for key in c_r:
        _close(c[key], c_r[key])
    # two steps against a 40-slot latent cache holding the prefix
    cache_np = _mla_cache_np(c_r, 40)
    cache_r = {k: jnp.asarray(v) for k, v in cache_np.items()}
    cache = {k: _t(v) for k, v in cache_np.items()}
    for i, S in enumerate((32, 33)):
        x1 = _x(cfg, S=1, seed=4 + i)
        y_r, cache_r = RA.mla_step(rp, jnp.asarray(x1), cfg, cache_r,
                                   jnp.int32(S), absorb=absorb)
        y, nc = PA.mla_step(pp, _t(x1), cfg, cache, S, absorb=absorb)
        assert nc is cache                        # updated in place
        _close(y, y_r)
        for key in cache_r:
            _close(cache[key], cache_r[key])


def test_mla_step_absorbed_equals_expanded(smoke_models):
    """The two decode forms compute one function (the port's own check,
    as the reference's ``absorb`` switch promises)."""
    cfg, _, lm = smoke_models["deepseek-v2-236b"]
    pp = lm.blocks[0]["attn"]
    _, c = PA.mla_fwd(pp, _t(_x(cfg)), cfg, want_cache=True)
    cache_np = _mla_cache_np({k: _np(v) for k, v in c.items()}, 36)
    cache_np["pos"] = cache_np["pos"].astype(np.int32)
    x1 = _t(_x(cfg, S=1, seed=7))
    ys = [PA.mla_step(pp, x1, cfg, {k: _t(v) for k, v in cache_np.items()},
                      32, absorb=a)[0] for a in (True, False)]
    _close(ys[0], ys[1])


# ---------------------------------------------------------------------------
# MoE: routing, capacity, int8 experts
# ---------------------------------------------------------------------------
def _moe_params(cfg, dtype, seed=0):
    """The reference's MoE subtree (experts drawn in ``dtype``) and the
    port's copy of it, as dicts of tensors."""
    p = init_params(RM.moe_specs(cfg), jax.random.PRNGKey(seed), dtype)
    return p, {k: convert._tensor(np.asarray(v)) for k, v in p.items()}


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_fwd_matches_reference(arch, dtype):
    cfg = cb.smoke(arch)
    jdt = jnp.float32 if dtype == "fp32" else jnp.bfloat16
    p_r, p = _moe_params(cfg, jdt)
    x = _x(cfg, scale=0.5)
    y_r, aux_r = RM.moe_fwd(p_r, jnp.asarray(x, jdt), cfg)
    y, aux = PM.moe_fwd(p, _t(x).to(p["w_up"].dtype), cfg)
    assert y.dtype == p["w_up"].dtype and y.shape == y_r.shape
    if dtype == "fp32":
        _close(y, y_r)
    else:
        assert _rel(y_r, y) < BF16_REL
    _close(aux, aux_r)


def test_moe_capacity_drops_as_the_reference():
    """capacity_factor 1.0: C = 8 slots an expert for 32 tokens x top-2
    over 8 experts, so the busiest experts drop assignments; the port
    drops the same ones (stable order by expert, then token)."""
    cfg = cb.smoke("deepseek-v2-236b").replace(capacity_factor=1.0)
    p_r, p = _moe_params(cfg, jnp.float32, seed=3)
    x = _x(cfg, S=16, scale=0.5)
    hf = PL.rms_norm(_t(x), p["ln"], cfg.norm_eps).reshape(-1, cfg.d_model)
    _, topi, _ = PM._route(hf, p["router"], cfg.experts_per_token)
    C = PM._capacity(hf.shape[0], cfg.experts_per_token, cfg.n_experts, 1.0)
    load = torch.bincount(topi.reshape(-1), minlength=cfg.n_experts)
    assert C == RM._capacity(hf.shape[0], cfg.experts_per_token,
                             cfg.n_experts, 1.0) == 8
    assert int(load.max()) > C                    # tokens do drop
    y_r, _ = RM.moe_fwd(p_r, jnp.asarray(x), cfg)
    y, _ = PM.moe_fwd(p, _t(x), cfg)
    _close(y, y_r)
    # and the drop is visible: a dropless run differs
    y_all, _ = PM.moe_fwd(p, _t(x), cfg.replace(capacity_factor=16.0))
    assert float((y_all - y).abs().max()) > 1e-3


@pytest.mark.parametrize("T,k,E,cf", [(1, 6, 160, 1.25), (8, 6, 160, 1.25),
                                      (16384, 6, 160, 1.25),
                                      (16384, 8, 256, 1.25), (64, 2, 8, 1.0),
                                      (1024, 2, 8, 16.0), (7, 3, 5, 0.5)])
def test_capacity_matches_reference(T, k, E, cf):
    assert PM._capacity(T, k, E, cf) == RM._capacity(T, k, E, cf)


def test_route_breaks_ties_to_the_lower_expert():
    """Equal gates rank by expert id, as ``jax.lax.top_k``'s."""
    rng = np.random.default_rng(0)
    col = rng.normal(size=(16, 1)).astype(np.float32)
    router = np.concatenate([col, col * 2, col, col * 2, col], axis=1)
    h = rng.normal(size=(5, 16)).astype(np.float32)
    w_r, i_r, aux_r = RM._route(jnp.asarray(h), jnp.asarray(router), 3)
    w, i, aux = PM._route(_t(h), _t(router), 3)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_r))
    _close(w, w_r)
    _close(aux, aux_r)


def test_quantize_expert_weights_matches_reference():
    cfg = cb.smoke("deepseek-v3-671b")
    p_r, p = _moe_params(cfg, jnp.bfloat16)
    names = ("w_gate", "w_up", "w_down")
    q_r = RM.quantize_expert_weights({k: p_r[k] for k in names})
    q = PM.quantize_expert_weights({k: p[k] for k in names})
    assert q.keys() == q_r.keys()
    for key, want in q_r.items():
        got = q[key]
        assert str(got.dtype).split(".")[-1] == str(want.dtype)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        if key.startswith("w_"):
            assert int(got.abs().max()) == 127     # not all zeros


def test_int8_expert_specs_initialise_to_zeros():
    """An int8 "normal" spec draws N(0, 0.02^2) and casts: all zeros, on
    both sides.  So int8 runs quantise bf16-drawn experts instead."""
    cfg = pcb.smoke("deepseek-v2-236b").replace(expert_weights_dtype="int8")
    p = p_init_params(PM.moe_specs(cfg), torch.Generator().manual_seed(0),
                      torch.bfloat16)
    assert p["w_gate"].dtype == torch.int8 and p["s_gate"].dtype == \
        torch.float32 and p["router"].dtype == torch.float32
    assert int(p["w_gate"].abs().max()) == 0
    r = init_params(RM.moe_specs(cb.smoke("deepseek-v2-236b").replace(
        expert_weights_dtype="int8")), jax.random.PRNGKey(0), jnp.bfloat16)
    assert int(jnp.abs(r["w_gate"]).max()) == 0


@pytest.mark.parametrize("chunk_bytes", [None, 1])
@pytest.mark.parametrize("arch", ARCHS)
def test_int8_moe_fwd_matches_reference(arch, chunk_bytes, monkeypatch):
    """int8 experts (quantised from bf16 draws) on both sides, bf16
    activations; ``chunk_bytes`` 1 casts one expert at a time."""
    if chunk_bytes:
        monkeypatch.setattr(PM, "CAST_BYTES", chunk_bytes)
    cfg = cb.smoke(arch)
    cfg8 = cfg.replace(expert_weights_dtype="int8")
    p_r, p = _moe_params(cfg, jnp.bfloat16)
    names = ("w_gate", "w_up", "w_down")
    p8_r = dict(p_r, **RM.quantize_expert_weights({k: p_r[k]
                                                   for k in names}))
    p8 = dict(p, **PM.quantize_expert_weights({k: p[k] for k in names}))
    x = _x(cfg, scale=0.5)
    y_r, _ = RM.moe_fwd(p8_r, jnp.asarray(x, jnp.bfloat16), cfg8)
    y, _ = PM.moe_fwd(p8, _t(x).bfloat16(), cfg8)
    assert y.dtype == torch.bfloat16
    assert _rel(y_r, y) < INT8_REL
    # int8 experts stay close to the bf16 experts they came from
    y16, _ = PM.moe_fwd(p, _t(x).bfloat16(), cfg)
    assert _rel(y16, y) < INT8_REL


# ---------------------------------------------------------------------------
# the slice as a whole: prefill, then greedy decode
# ---------------------------------------------------------------------------
def _stack_trees(ts):
    if isinstance(ts[0], dict):
        return {k: _stack_trees([t[k] for t in ts]) for k in ts[0]}
    return np.stack(ts)


def stack(tree):
    """The port's cache tree (lists of blocks and layers) as the
    reference's stacked tree, in numpy."""
    if isinstance(tree, dict):
        return {k: stack(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return _stack_trees([stack(t) for t in tree])
    return _np(tree)


_RUNS = {}


def modality_inputs(cfg, dtype, seed=0):
    """The vlm family's ``patches`` or the audio family's ``frames``, N(0, 1)
    from a seed with numpy, in ``dtype`` ("fp32" or "bf16"): (reference's
    dict, port's dict); empty for the other families."""
    shape = {"vlm": (B, cfg.n_patches, cfg.vit_dim),
             "audio": (B, cfg.encoder_len, cfg.d_model)}.get(cfg.family)
    if shape is None:
        return {}, {}
    name = "patches" if cfg.family == "vlm" else "frames"
    a = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    if dtype == "fp32":
        return {name: jnp.asarray(a)}, {name: _t(a)}
    return {name: jnp.asarray(a, jnp.bfloat16)}, {name: _t(a).bfloat16()}


def lm_run(arch, dtype, S, **replace):
    """Both sides on the same weights, prompt and modality inputs, the smoke
    config with ``replace``'s fields: prefill, then GEN - 1 decode steps.
    fp32 decodes greedily on each side; bf16 feeds the reference's greedy
    tokens to both (teacher forcing).  Returns a dict of numpy results
    (cached per argument)."""
    key = (arch, dtype, S, tuple(sorted(replace.items())))
    if key in _RUNS:
        return _RUNS[key]
    cfg, pcfg = cb.smoke(arch).replace(**replace), \
        pcb.smoke(arch).replace(**replace)
    jdt = jnp.float32 if dtype == "fp32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "fp32" else torch.bfloat16
    params = _ref_params(cfg, jdt)
    lm = convert.lm_params(pcfg, jax.tree.map(np.asarray, params))
    toks = np.random.default_rng(S).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    ref_in, port_in = modality_inputs(cfg, dtype)
    T = S + GEN
    # the reference, as run_lm runs it (caches in the weights' dtype)
    last, cache = jax.jit(lambda p, b: rm.prefill(p, cfg, b))(
        params, {"tokens": jnp.asarray(toks), **ref_in})
    cache_t = jax.tree.map(lambda a: a.astype(jdt) if a.dtype == jnp.bfloat16
                           else a, rsp.init_cache(cfg, B, T))
    prefill_cache = cache
    cache = jax.tree.map(_put_jax, cache_t, cache)
    step = jax.jit(lambda p, t, i, c: rm.decode_step(p, cfg, t, i, c))
    ref_logits, ref_toks = [np.asarray(last, np.float32)], []
    tok = jnp.argmax(last, -1).astype(jnp.int32)[:, None]
    for i in range(GEN - 1):
        ref_toks.append(np.asarray(tok))
        logits, cache = step(params, tok, jnp.int32(S + i), cache)
        ref_logits.append(np.asarray(logits, np.float32))
        tok = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
    ref_toks.append(np.asarray(tok))
    # the port
    with torch.inference_mode():
        plast, pcache = pm.prefill(lm, pcfg, {"tokens": _t(toks), **port_in})
        port_prefill_cache = stack(pcache)
        pc = serve._tree_map2(serve._put, psp.init_cache(pcfg, B, T,
                                                         dtype=tdt), pcache)
        port_logits, port_toks = [_np(plast)], []
        ptok = torch.argmax(plast, -1).to(torch.int32)[:, None]
        for i in range(GEN - 1):
            port_toks.append(ptok.numpy())
            feed = ptok if dtype == "fp32" else _t(ref_toks[i])
            logits, pc = pm.decode_step(lm, pcfg, feed, S + i, pc)
            port_logits.append(_np(logits))
            ptok = torch.argmax(logits, -1).to(torch.int32)[:, None]
        port_toks.append(ptok.numpy())
    _RUNS[key] = out = {
        "ref_logits": ref_logits, "port_logits": port_logits,
        "ref_toks": np.concatenate(ref_toks, 1),
        "port_toks": np.concatenate(port_toks, 1),
        "ref_cache": _flat(prefill_cache), "port_cache":
        _flat(port_prefill_cache), "lm": lm, "tokens": toks,
        "inputs": port_in}
    return out


def check_prefill_fp32(r):
    _close(r["port_logits"][0], r["ref_logits"][0])
    assert r["port_cache"].keys() == r["ref_cache"].keys()
    for k, want in r["ref_cache"].items():
        assert r["port_cache"][k].shape == want.shape, k
        _close(r["port_cache"][k], want)


def check_greedy_fp32(r):
    np.testing.assert_array_equal(r["port_toks"], r["ref_toks"])
    for got, want in zip(r["port_logits"], r["ref_logits"]):
        _close(got, want)


def check_bf16(r):
    assert len(r["port_logits"]) == GEN
    for got, want in zip(r["port_logits"], r["ref_logits"]):
        assert _rel(want, got) < BF16_REL


@pytest.mark.parametrize("S", [32, 512])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_fp32_matches_reference(arch, S):
    check_prefill_fp32(lm_run(arch, "fp32", S))


@pytest.mark.parametrize("S", [32, 512])
@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_decode_fp32_matches_reference(arch, S):
    check_greedy_fp32(lm_run(arch, "fp32", S))


@pytest.mark.parametrize("S", [32, 512])
@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_teacher_forced_logits_match_reference(arch, S):
    check_bf16(lm_run(arch, "bf16", S))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_aux_matches_reference(smoke_models, arch):
    """``forward`` returns the MoE layers' summed aux loss, as the
    reference's."""
    cfg, params, lm = smoke_models[arch]
    toks = np.random.default_rng(9).integers(0, cfg.vocab_size, (B, 32))
    logits_r, aux_r, _ = rm.forward(params, cfg,
                                    {"tokens": jnp.asarray(toks)})
    logits, aux, _ = pm.forward(lm, pcb.smoke(arch), {"tokens": _t(toks)})
    _close(logits, logits_r)
    _close(aux, aux_r)
    assert float(aux) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_run_lm_end_to_end(arch):
    """``run_lm`` on the CPU with the reference's weights and prompt gives
    the reference's greedy tokens (fp32 weights and caches)."""
    r = lm_run(arch, "fp32", 32)
    toks = serve.run_lm(arch, device="cpu", params=r["lm"],
                        tokens=r["tokens"], gen=GEN)
    assert toks.dtype == torch.int32 and tuple(toks.shape) == (B, GEN)
    np.testing.assert_array_equal(toks.numpy(), r["ref_toks"])


@pytest.mark.parametrize("arch", ARCHS)
def test_run_lm_defaults(arch, capsys):
    toks = serve.run_lm(arch, device="cpu")
    assert tuple(toks.shape) == (2, 16)
    assert int(toks.min()) >= 0 and int(toks.max()) < 256
    assert f"[serve-lm] {arch}: generated 16x2 tokens" in \
        capsys.readouterr().out


def test_int8_expert_model_decodes():
    """A whole smoke model with int8 experts quantised from the bf16 ones:
    the experts are not all zero, and its prefill logits stay within
    INT8_REL of the bf16-expert model's."""
    arch = "deepseek-v3-671b"
    cfg = pcb.smoke(arch)
    cfg8 = cfg.replace(expert_weights_dtype="int8")
    g = torch.Generator().manual_seed(0)
    tree = p_init_params(pm.param_specs(cfg), g, torch.bfloat16)
    lm16 = pm.LM(cfg, tree)
    tree8 = dict(tree, blocks=[dict(b, moe=PM.quantize_expert_weights(
        b["moe"])) for b in tree["blocks"]])
    lm8 = pm.LM(cfg8, tree8)
    assert all(int(b["moe"]["w_up"].abs().max()) > 0 for b in lm8.blocks)
    assert lm8.blocks[0]["moe"]["w_up"].dtype == torch.int8
    toks = torch.randint(0, cfg.vocab_size, (B, 32), generator=g)
    with torch.inference_mode():
        l16, _ = pm.prefill(lm16, cfg, {"tokens": toks})
        l8, c8 = pm.prefill(lm8, cfg8, {"tokens": toks})
    assert _rel(l16, l8) < INT8_REL
    assert set(c8) == {"scan", "prefix"}
