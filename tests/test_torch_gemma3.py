"""The port's gemma3 family (5 local sliding-window layers : 1 global, a
ring cache for the local layers) vs the JAX reference, on the CPU.

Here ``flash_attention_cuda`` takes its plain PyTorch path (the tensors lie
on the CPU); the CUDA kernel is held against that path on the card by
``chip_smoke.py``.  The smoke config's window is 8, so prompts of 32 and
512 take the reference's banded path, prompts of 10 and 12 its masked
plain path, and decode wraps the ring.  Where 2S is not a multiple of the
window (S = 9, 10) the reference's prefill ring puts positions in slots
decode then overwrites too early (ROADMAP R9); the port puts position p
at slot p % window for every S, and is held there against the
reference's ring rolled into that layout.  Inputs are made
from a seed with numpy and handed to both sides; weights are the
reference's own, carried across by ``convert.lm_params``.

Oracles and tolerances (``test_torch_lm.py``'s): layers and whole models
in fp32 within ``TOL`` = 1e-5 max abs, greedy tokens equal; whole models
in bf16, teacher-forced on the reference's tokens, within ``BF16_REL`` =
2e-2 of max |logit|.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as cb
from repro.models import attention as RA
from repro.models import model as rm
from repro.sharding import init_params
from repro_torch import convert
from repro_torch.configs import base as pcb
from repro_torch.launch import serve
from repro_torch.models import attention as PA
from repro_torch.models import model as pm
from test_torch_lm import B, GEN, TOL, _close, _put_jax, _shapes, _t
from test_torch_moe import (check_bf16, check_greedy_fp32,
                            check_prefill_fp32, lm_run)

ARCH = "gemma3-12b"


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Run this file's torch ops on one core: the other test workers share
    the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_config_copies_the_reference():
    assert dataclasses.asdict(pcb.get(ARCH)) == \
        dataclasses.asdict(cb.get(ARCH))
    assert dataclasses.asdict(pcb.smoke(ARCH)) == \
        dataclasses.asdict(cb.smoke(ARCH))


@pytest.mark.parametrize("T", [4, 8, 9, 40])
def test_specs_match_the_reference(T):
    """Parameters stacked per superblock, and each local layer's ring of
    min(window, T) slots."""
    cfg, pcfg = cb.smoke(ARCH), pcb.smoke(ARCH)
    assert _shapes(pm.param_specs(pcfg)) == _shapes(rm.param_specs(cfg))
    assert _shapes(pm.cache_specs(pcfg, 2, T)) == \
        _shapes(rm.cache_specs(cfg, 2, T))
    ring = pm.cache_specs(pcfg, 2, T)[0]["local"][0]["k"]
    assert ring.shape[1] == min(cfg.sliding_window, T)


def test_full_config_specs_match_the_reference():
    """The published config: 48 layers in 8 superblocks of 5 local + 1
    global, head dim 240, a tied 262,144-token embedding."""
    cfg, pcfg = cb.get(ARCH), pcb.get(ARCH)
    assert _shapes(pm.param_specs(pcfg)) == _shapes(rm.param_specs(cfg))
    assert _shapes(pm.cache_specs(pcfg, 8, 2080)) == \
        _shapes(rm.cache_specs(cfg, 8, 2080))
    assert pcfg.dh == 240 and pcfg.n_superblocks == 8
    assert "head" not in pm.param_specs(pcfg)["embed"]


@pytest.fixture(scope="module")
def smoke_model():
    cfg = cb.smoke(ARCH)
    params = init_params(rm.param_specs(cfg), jax.random.PRNGKey(0),
                         jnp.float32)
    return cfg, params, convert.lm_params(pcb.smoke(ARCH),
                                          jax.tree.map(np.asarray, params))


def _layer(smoke_model, i):
    """Layer i of the first superblock: (reference params, port params,
    theta, window)."""
    cfg, params, lm = smoke_model
    glob = i == cfg.superblock - 1
    rp = jax.tree.map(lambda a: a[0, i], params["blocks"]["attn"])
    return (rp, lm.blocks[0]["attn"][i],
            cfg.rope_theta_global if glob else cfg.rope_theta,
            0 if glob else cfg.sliding_window)


def _x(cfg, S, seed=1):
    return np.random.default_rng(seed).normal(
        size=(B, S, cfg.d_model)).astype(np.float32)


def _ring_fix(c_r, S, win):
    """The reference's prefill cache with its ring rolled so that position
    p sits at slot p % window (ROADMAP R9): its roll (-S) % window plus
    2S % window is S % window."""
    if not win or S <= win:
        return c_r
    return {k: jnp.roll(a, 2 * S % win, axis=1) for k, a in c_r.items()}


@pytest.mark.parametrize("layer", [0, 5], ids=["local", "global"])
@pytest.mark.parametrize("S", [5, 8, 10, 12, 32])
def test_gqa_fwd_then_steps_match_reference(smoke_model, layer, S):
    """Prefill at S < window, S = window, S > window (no multiple; at
    S = 10 the reference's ring is 2S % window = 4 slots off, at S = 12 it
    is right) and S = 4 windows (the banded path), then decode steps
    through the ring (local) or the cache (global) long enough to wrap the
    ring twice, the reference stepping from its prefill cache in the
    port's layout."""
    cfg = smoke_model[0]
    rp, pp, theta, win = _layer(smoke_model, layer)
    x = _x(cfg, S)
    y_r, c_r = RA.gqa_fwd(rp, jnp.asarray(x), cfg, theta=theta, window=win,
                          want_cache=True)
    c_r = _ring_fix(c_r, S, win)
    y, c = PA.gqa_fwd(pp, _t(x), cfg, theta=theta, window=win,
                      want_cache=True)
    _close(y, y_r)
    assert c.keys() == c_r.keys()
    for key in c_r:
        assert tuple(c[key].shape) == c_r[key].shape
        _close(c[key], c_r[key])
    n = 2 * cfg.sliding_window + 3
    T = S + n
    spec = RA.cache_spec_gqa(cfg, B, T, window=win)
    empty = {k: (jnp.full(s.shape, 1 << 30, s.dtype) if k == "pos" else
                 jnp.zeros(s.shape, jnp.float32)) for k, s in spec.items()}
    cache_r = {k: _put_jax(empty[k], c_r[k]) for k in empty}
    cache = {k: _t(v) for k, v in cache_r.items()}
    for i in range(n):
        x1 = _x(cfg, 1, seed=10 + i)
        y_r, cache_r = RA.gqa_step(rp, jnp.asarray(x1), cfg, cache_r,
                                   jnp.int32(S + i), theta=theta,
                                   window=win)
        y, nc = PA.gqa_step(pp, _t(x1), cfg, cache, S + i, theta=theta,
                            window=win)
        assert nc is cache                        # updated in place
        _close(y, y_r)
        for key in cache_r:
            _close(cache[key], cache_r[key])


@pytest.mark.parametrize("S", [32, 512])
def test_prefill_fp32_matches_reference(S):
    check_prefill_fp32(lm_run(ARCH, "fp32", S))


@pytest.mark.parametrize("S", [32, 512])
def test_greedy_decode_fp32_matches_reference(S):
    check_greedy_fp32(lm_run(ARCH, "fp32", S))


@pytest.mark.parametrize("S", [32, 512])
def test_bf16_teacher_forced_logits_match_reference(S):
    check_bf16(lm_run(ARCH, "bf16", S))


def test_run_lm_end_to_end():
    """``run_lm`` on the CPU with the reference's weights and prompt gives
    the reference's greedy tokens (fp32 weights and caches)."""
    r = lm_run(ARCH, "fp32", 32)
    toks = serve.run_lm(ARCH, device="cpu", params=r["lm"],
                        tokens=r["tokens"], gen=GEN)
    assert toks.dtype == torch.int32 and tuple(toks.shape) == (B, GEN)
    np.testing.assert_array_equal(toks.numpy(), r["ref_toks"])


def test_run_lm_defaults(capsys):
    toks = serve.run_lm(ARCH, device="cpu")
    assert tuple(toks.shape) == (2, 16)
    assert int(toks.min()) >= 0 and int(toks.max()) < 256
    assert f"[serve-lm] {ARCH}: generated 16x2 tokens" in \
        capsys.readouterr().out


def _decode_vs_forward(S):
    """Max abs error of each decode step after an S-token prefill against
    the full forward at that position (fp32 smoke model)."""
    cfg = pcb.smoke(ARCH)
    g = torch.Generator().manual_seed(0)
    lm = pm.init(cfg, g, torch.float32)
    toks = torch.randint(0, cfg.vocab_size, (B, S + 6), generator=g,
                         dtype=torch.int32)
    with torch.inference_mode():
        last, cache = serve.prefill_cache(lm, cfg, toks[:, :S], S + 6)
        full, _, _ = pm.forward(lm, cfg, {"tokens": toks})
        errs = [float((last - full[:, S - 1]).abs().max())]
        for i in range(S, S + 6):
            got, cache = pm.decode_step(lm, cfg, toks[:, i:i + 1], i, cache)
            errs.append(float((got - full[:, i]).abs().max()))
    return errs


@pytest.mark.parametrize("S", [5, 8, 12, 16])
def test_decode_matches_forward(S):
    """prefill + decode steps past the window == full forward at each
    position (the port's copy of ``test_archs.py``'s check, on the port
    alone), at prompts where 2S is a multiple of the window."""
    assert max(_decode_vs_forward(S)) <= TOL


@pytest.mark.parametrize("S", [9, 10, 12])
def test_ring_roll_follows_the_reference(smoke_model, S):
    """ROADMAP R9: the reference rolls the prefill ring by (-S) % window,
    which puts position p at slot p % window only where 2S is a multiple
    of the window (S = 12 here); at S = 9 and 10 its decode overwrites a
    key still inside the window.  The port rolls by S % window, so its
    decode steps equal the full forward at every S, and its ring is the
    reference's where the reference is right and that ring rolled by
    2S % window elsewhere."""
    assert max(_decode_vs_forward(S)) <= TOL
    cfg = smoke_model[0]
    rp, pp, theta, win = _layer(smoke_model, 0)
    x = _x(cfg, S)
    _, c_r = RA.gqa_fwd(rp, jnp.asarray(x), cfg, theta=theta, window=win,
                        want_cache=True)
    _, c = PA.gqa_fwd(pp, _t(x), cfg, theta=theta, window=win,
                      want_cache=True)
    for key in c_r:
        _close(c[key], jnp.roll(c_r[key], 2 * S % win, axis=1))
    assert (c["pos"] % win == torch.arange(win)).all()
