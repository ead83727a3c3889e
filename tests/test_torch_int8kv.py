"""The port's int8 KV cache (``kv_cache_dtype="int8"``) vs the JAX
reference, on the CPU: ``_quant_rows``, ``gqa_step`` on a full and a ring
(sliding-window) cache, ``mla_step`` in both ``absorb`` forms, and whole
smoke models (codeqwen1.5-7b, deepseek-v2-236b, gemma3-12b).

Inputs are made from a seed with numpy and handed to both sides; weights
are the reference's own, carried across by ``convert.lm_params``.

Oracles and tolerances:
  * ``_quant_rows``: the int8 rows and fp32 scales equal the reference's
    (the same IEEE divisions and round-half-even).
  * layers and whole models in fp32: ``TOL`` = 1e-5 max abs, greedy tokens
    equal; the scales within TOL, and the int8 rows within one level of
    the reference's in at most ``FLIPS`` of their entries: the two sides
    quantise keys whose fp32 values differ in the last bits (another
    summation order), so a value within an ulp of a half step may round
    either way.  The steps are fed the reference's prefill cache.
  * whole models in bf16, teacher-forced on the reference's tokens:
    within ``BF16_REL`` = 2e-2 of max |logit|.
  * the port alone, prefill + one int8 decode step against the full
    forward at that position: within 2e-2 of max |logit|, the bound of the
    reference's own ``test_int8_kv_cache_decode_parity``.
"""
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
from repro_torch.launch import specs as psp
from repro_torch.models import attention as PA
from repro_torch.models import model as pm
from test_torch_lm import B, GEN, _close, _np, _rel, _t
from test_torch_moe import _mla_cache_np, check_bf16, check_greedy_fp32, \
    lm_run

INT8 = {"kv_cache_dtype": "int8"}
FLIPS = 1e-3
ARCHS = ["codeqwen1.5-7b", "deepseek-v2-236b", "gemma3-12b"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Run this file's torch ops on one core: the other test workers share
    the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _x(cfg, S=32, seed=1):
    return np.random.default_rng(seed).normal(
        size=(B, S, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_quant_rows_equal_the_reference(dtype):
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(4, 37, 3, 48)) * np.exp(rng.normal(
        size=(4, 37, 3, 1)))).astype(np.float32)
    x[0, 0, 0] = 0.0                    # an all-zero row: the 1e-12 floor
    jx = jnp.asarray(x) if dtype == "fp32" else jnp.asarray(x, jnp.bfloat16)
    tx = _t(x) if dtype == "fp32" else _t(x).bfloat16()
    q_r, s_r = RA._quant_rows(jx)
    q, s = PA._quant_rows(tx)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_r))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_r))


def _models(arch):
    cfg = cb.smoke(arch).replace(**INT8)
    params = init_params(rm.param_specs(cfg), jax.random.PRNGKey(0),
                         jnp.float32)
    lm = convert.lm_params(pcb.smoke(arch).replace(**INT8),
                           jax.tree.map(np.asarray, params))
    return cfg, params, lm


def _int8_cache(c_r, T, window_slots=0):
    """The reference's prefill cache in a T-long cache (empty slots at
    position 1 << 30), or as it is when it already fills a ring of
    ``window_slots``."""
    out = {}
    for key, a in c_r.items():
        a = np.asarray(a)
        if window_slots:
            out[key] = np.array(a)
            continue
        full = np.zeros((a.shape[0], T) + a.shape[2:], a.dtype)
        if key == "pos":
            full[:] = 1 << 30
        full[:, :a.shape[1]] = a
        out[key] = full
    return out


def _check_rows(got, want):
    """int8 rows within one level, at most FLIPS of them off."""
    d = np.abs(_np(got) - _np(want))
    assert d.max() <= 1 and (d > 0).mean() <= FLIPS, (d.max(),
                                                      (d > 0).mean())


def _check_cache(got, want):
    assert got.keys() == want.keys()
    for key in want:
        if key in ("k", "v", "ckv"):
            _check_rows(got[key], want[key])
        elif key == "pos":
            np.testing.assert_array_equal(_np(got[key]), _np(want[key]))
        else:
            _close(got[key], want[key])


@pytest.mark.parametrize("where", ["full", "window"])
def test_gqa_step_int8_matches_reference(where):
    """Prefill the int8 cache, then three steps against it: a full cache
    (codeqwen) and gemma3's ring of a local layer (S = 12, where the
    reference's roll puts position p at slot p % window, ROADMAP R9)."""
    arch = "codeqwen1.5-7b" if where == "full" else "gemma3-12b"
    cfg, params, lm = _models(arch)
    theta = cfg.rope_theta
    if where == "full":
        rp = jax.tree.map(lambda a: a[0], params["blocks"]["attn"])
        pp, win, S = lm.blocks[0]["attn"], 0, 32
    else:
        rp = jax.tree.map(lambda a: a[0, 1], params["blocks"]["attn"])
        pp, win, S = lm.blocks[0]["attn"][1], cfg.sliding_window, 12
    x = _x(cfg, S)
    y_r, c_r = RA.gqa_fwd(rp, jnp.asarray(x), cfg, theta=theta, window=win,
                          want_cache=True)
    y, c = PA.gqa_fwd(pp, _t(x), cfg, theta=theta, window=win,
                      want_cache=True)
    _close(y, y_r)
    _check_cache(c, c_r)
    assert c["k"].dtype == torch.int8 and c["k_s"].shape == c["k"].shape[:3]
    cache_np = _int8_cache(c_r, S + 8, window_slots=win)
    cache_r = {k: jnp.asarray(v) for k, v in cache_np.items()}
    cache = {k: _t(v) for k, v in cache_np.items()}
    for i in range(3):
        x1 = _x(cfg, S=1, seed=4 + i)
        y_r, cache_r = RA.gqa_step(rp, jnp.asarray(x1), cfg, cache_r,
                                   jnp.int32(S + i), theta=theta, window=win)
        y, nc = PA.gqa_step(pp, _t(x1), cfg, cache, S + i, theta=theta,
                            window=win)
        assert nc is cache                        # updated in place
        _close(y, y_r)
        _check_cache(cache, cache_r)


@pytest.mark.parametrize("absorb", [True, False])
def test_mla_step_int8_matches_reference(absorb):
    cfg, params, lm = _models("deepseek-v2-236b")
    rp = jax.tree.map(lambda a: a[1], params["blocks"]["attn"])
    pp = lm.blocks[1]["attn"]
    x = _x(cfg)
    y_r, c_r = RA.mla_fwd(rp, jnp.asarray(x), cfg, want_cache=True)
    y, c = PA.mla_fwd(pp, _t(x), cfg, want_cache=True)
    _close(y, y_r)
    _check_cache(c, c_r)
    assert c["ckv"].dtype == torch.int8
    cache_np = _mla_cache_np(c_r, 40)
    cache_r = {k: jnp.asarray(v) for k, v in cache_np.items()}
    cache = {k: _t(v) for k, v in cache_np.items()}
    for i, S in enumerate((32, 33)):
        x1 = _x(cfg, S=1, seed=4 + i)
        y_r, cache_r = RA.mla_step(rp, jnp.asarray(x1), cfg, cache_r,
                                   jnp.int32(S), absorb=absorb)
        y, nc = PA.mla_step(pp, _t(x1), cfg, cache, S, absorb=absorb)
        assert nc is cache
        _close(y, y_r)
        _check_cache(cache, cache_r)


def _check_int8_prefill(r):
    """``check_prefill_fp32``, the int8 rows by ``_check_rows``."""
    _close(r["port_logits"][0], r["ref_logits"][0])
    assert r["port_cache"].keys() == r["ref_cache"].keys()
    for k, want in r["ref_cache"].items():
        got = r["port_cache"][k]
        assert got.shape == want.shape, k
        (_check_rows if k[-1] in ("k", "v", "ckv") else _close)(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_int8_prefill_and_greedy_decode_fp32_match_reference(arch):
    r = lm_run(arch, "fp32", 32, **INT8)
    _check_int8_prefill(r)
    check_greedy_fp32(r)


@pytest.mark.parametrize("arch", ARCHS)
def test_int8_bf16_teacher_forced_logits_match_reference(arch):
    check_bf16(lm_run(arch, "bf16", 32, **INT8))


@pytest.mark.parametrize("arch", ARCHS)
def test_int8_run_lm_end_to_end(arch):
    r = lm_run(arch, "fp32", 32, **INT8)
    toks = serve.run_lm(arch, device="cpu",
                        cfg=pcb.smoke(arch).replace(**INT8), params=r["lm"],
                        tokens=r["tokens"], gen=GEN)
    np.testing.assert_array_equal(toks.numpy(), r["ref_toks"])


@pytest.mark.parametrize("S", [8, 12, 16])
@pytest.mark.parametrize("arch", ARCHS)
def test_int8_decode_matches_forward(arch, S):
    """prefill + one decode step on the int8 cache == the full forward at
    position S (the reference's ``test_int8_kv_cache_decode_parity``, on
    the port alone), bf16 weights; gemma3's rings at S below, at and past
    its window of 8."""
    cfg = pcb.smoke(arch).replace(**INT8)
    g = torch.Generator().manual_seed(0)
    lm = pm.init(cfg, g)
    toks = psp.make_batch(cfg, S, B, g)["tokens"]
    with torch.inference_mode():
        last, cache = serve.prefill_cache(lm, cfg, toks, S + 4)
        tok = torch.argmax(last, -1).to(torch.int32)[:, None]
        got, _ = pm.decode_step(lm, cfg, tok, S, cache)
        ref, _, _ = pm.forward(lm, cfg, {"tokens": torch.cat([toks, tok],
                                                             1)})
    assert _rel(ref[:, -1], got) < 2e-2
