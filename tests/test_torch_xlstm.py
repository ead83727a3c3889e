"""The port's xLSTM family (xlstm-1.3b: mLSTM and sLSTM blocks) vs the JAX
reference, on the CPU.

No kernel of the reference serves this family: both blocks are plain
torch.  Inputs are made from a seed with numpy and handed to both sides;
weights are the reference's own, carried across by ``convert.lm_params``.

Oracles and tolerances:
  * ``mlstm_chunked`` in fp32 against the reference's: atol 2e-5, rtol
    1e-4 (the kernels' tests' fp32 bound: the chunked form's products run
    in another order, and the port writes each three-operand einsum as two
    products), for y and the final (C, n, m); and against the recurrent
    form (``mlstm_step`` token by token) at the same bound;
  * the layers' outputs in fp32: ``TOL`` = 1e-5 max abs; their recurrent
    states (C, n, m; c, n, m, h) at the bound above, as they grow to
    magnitudes of 10-20 over a sequence and carry the rounding of every
    step;
  * whole smoke models: fp32 greedy tokens equal, logits within ``TOL``
    and the prefill caches (the states) at the bound above; bf16,
    teacher-forced on the reference's tokens, within ``BF16_REL`` = 2e-2
    of max |logit|.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as cb
from repro.models import model as rm
from repro.models import xlstm as RX
from repro.sharding import init_params
from repro_torch import convert
from repro_torch.configs import base as pcb
from repro_torch.launch import serve
from repro_torch.launch import specs as psp
from repro_torch.models import model as pm
from repro_torch.models import xlstm as PX
from test_torch_lm import B, GEN, _close, _np, _rel, _t
from test_torch_moe import check_bf16, check_greedy_fp32, lm_run

ARCH = "xlstm-1.3b"
M_EMPTY = float(np.float32(-1e30))      # an empty state's stabilizer


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Run this file's torch ops on one core: the other test workers share
    the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _allclose(got, want):
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5, rtol=1e-4)


def _mlstm_inputs(Bt, S, H, D, seed=0):
    rng = np.random.default_rng(seed + S + D)
    q, k, v = (rng.normal(size=(Bt, S, H, D)).astype(np.float32) * s
               for s in (D ** -0.5, 1.0, 1.0))
    ig = rng.normal(size=(Bt, S, H)).astype(np.float32)
    logf = -np.log1p(np.exp(-(rng.normal(size=(Bt, S, H)) + 3.0))
                     ).astype(np.float32)
    return q, k, v, ig, logf


@pytest.mark.parametrize("shape", [(2, 64, 2, 16, 16), (2, 64, 3, 8, 64),
                                   (1, 256, 2, 32, 64), (2, 32, 4, 16, 32)],
                         ids=str)
@pytest.mark.parametrize("with_state", [False, True])
def test_mlstm_chunked_matches_reference(shape, with_state):
    Bt, S, H, D, chunk = shape
    args = _mlstm_inputs(Bt, S, H, D)
    state_r = state = None
    if with_state:
        rng = np.random.default_rng(9)
        st = (rng.normal(size=(Bt, H, D, D)).astype(np.float32),
              rng.normal(size=(Bt, H, D)).astype(np.float32),
              rng.normal(size=(Bt, H)).astype(np.float32))
        state_r, state = tuple(map(jnp.asarray, st)), tuple(map(_t, st))
    y_r, (C_r, n_r, m_r) = RX.mlstm_chunked(*map(jnp.asarray, args),
                                            state=state_r, chunk=chunk)
    y, (C, n, m) = PX.mlstm_chunked(*map(_t, args), state=state, chunk=chunk)
    assert y.dtype == torch.float32 and C.shape == (Bt, H, D, D)
    for got, want in ((y, y_r), (C, C_r), (n, n_r), (m, m_r)):
        _allclose(got, want)


def _ref_params(seed=0, dtype=jnp.float32):
    cfg = cb.smoke(ARCH)
    return cfg, init_params(rm.param_specs(cfg), jax.random.PRNGKey(seed),
                            dtype)


@pytest.fixture(scope="module")
def smoke_model():
    cfg, params = _ref_params()
    return cfg, params, convert.lm_params(pcb.smoke(ARCH),
                                          jax.tree.map(np.asarray, params))


def _x(cfg, S, seed=1):
    return np.random.default_rng(seed).normal(
        size=(B, S, cfg.d_model)).astype(np.float32)


def _layers(smoke_model, block=1):
    cfg, params, lm = smoke_model
    rb = jax.tree.map(lambda a: a[block], params["blocks"])
    return cfg, (jax.tree.map(lambda a: a[0], rb["m"]), lm.blocks[block]
                 ["m"][0]), (rb["s"], lm.blocks[block]["s"])


@pytest.mark.parametrize("S", [32, 512])
def test_mlstm_fwd_and_step_match_reference(smoke_model, S):
    cfg, (rp, pp), _ = _layers(smoke_model)
    x = _x(cfg, S)
    y_r, c_r = RX.mlstm_fwd(rp, jnp.asarray(x), cfg, want_cache=True)
    y, c = PX.mlstm_fwd(pp, _t(x), cfg, want_cache=True)
    _close(y, y_r)
    for key in ("C", "n", "m"):
        _allclose(c[key], c_r[key])
    cache_r = c_r
    for i in range(3):
        x1 = _x(cfg, 1, seed=5 + i)
        y_r, cache_r = RX.mlstm_step(rp, jnp.asarray(x1), cfg, cache_r)
        y, nc = PX.mlstm_step(pp, _t(x1), cfg, c)
        assert nc is c                    # the state goes into the cache
        _close(y, y_r)
        for key in ("C", "n", "m"):
            _allclose(c[key], cache_r[key])


def test_mlstm_chunked_equals_the_recurrent_steps(smoke_model):
    """The chunked prefill (two chunks of 256 at S = 512, one at S = 32)
    and ``mlstm_step`` run token by token from the empty state compute the
    same outputs and final state (the port alone)."""
    cfg, (_, pp), _ = _layers(smoke_model, block=0)
    for S in (32, 512):
        x = _t(_x(cfg, S, seed=3))
        y, c = PX.mlstm_fwd(pp, x, cfg, want_cache=True)
        cache = psp.init_cache(cfg, B, 1, dtype=torch.float32)[0]["m"][0]
        assert float(cache["m"].max()) == M_EMPTY
        ys = [PX.mlstm_step(pp, x[:, t:t + 1], cfg, cache)[0]
              for t in range(S)]
        _allclose(torch.cat(ys, dim=1), y)
        for key in ("C", "n", "m"):
            _allclose(cache[key], c[key])


@pytest.mark.parametrize("S", [1, 32, 100])
def test_slstm_scan_matches_reference(smoke_model, S):
    cfg, _, (rp, pp) = _layers(smoke_model)
    H, dh = cfg.n_heads, cfg.d_model // cfg.n_heads
    xg = np.random.default_rng(S).normal(
        size=(B, S, 4 * cfg.d_model)).astype(np.float32)
    st_r, hs_r = RX._slstm_scan(jnp.asarray(xg), rp["r_gates"], H, dh)
    st, hs = PX._slstm_scan(_t(xg), pp["r_gates"], H, dh)
    assert hs.shape == (S, B, H, dh)
    _close(hs, hs_r)
    for got, want in zip(st, st_r):
        _allclose(got, want)


@pytest.mark.parametrize("S", [32, 512])
def test_slstm_fwd_and_step_match_reference(smoke_model, S):
    cfg, _, (rp, pp) = _layers(smoke_model)
    x = _x(cfg, S)
    y_r, c_r = RX.slstm_fwd(rp, jnp.asarray(x), cfg, want_cache=True)
    y, c = PX.slstm_fwd(pp, _t(x), cfg, want_cache=True)
    _close(y, y_r)
    for key in ("c", "n", "m", "hp"):
        _allclose(c[key], c_r[key])
    cache_r = c_r
    for i in range(3):
        x1 = _x(cfg, 1, seed=5 + i)
        y_r, cache_r = RX.slstm_step(rp, jnp.asarray(x1), cfg, cache_r)
        y, nc = PX.slstm_step(pp, _t(x1), cfg, c)
        assert nc is c
        _close(y, y_r)
        for key in ("c", "n", "m", "hp"):
            _allclose(c[key], cache_r[key])


def test_init_cache_stabilizers():
    """Every fp32 leaf named ``m`` (the mLSTM's (B, H), the sLSTM's
    (B, H, dh)) starts at -1e30, the rest at 0, as the reference's."""
    cfg = pcb.smoke(ARCH)
    cache = psp.init_cache(cfg, 2, 8)
    blk = cache[0]
    assert float(blk["m"][0]["m"].max()) == M_EMPTY
    assert float(blk["s"]["m"].max()) == M_EMPTY
    assert blk["m"][0]["C"].dtype == torch.float32
    assert float(blk["m"][0]["C"].abs().max()) == 0.0
    assert float(blk["s"]["hp"].abs().max()) == 0.0


@pytest.mark.parametrize("S", [32, 512])
def test_prefill_and_greedy_decode_fp32_match_reference(S):
    r = lm_run(ARCH, "fp32", S)
    _close(r["port_logits"][0], r["ref_logits"][0])
    assert r["port_cache"].keys() == r["ref_cache"].keys()
    for k, want in r["ref_cache"].items():
        assert r["port_cache"][k].shape == want.shape, k
        _allclose(r["port_cache"][k], want)
    check_greedy_fp32(r)


@pytest.mark.parametrize("S", [32, 512])
def test_bf16_teacher_forced_logits_match_reference(S):
    check_bf16(lm_run(ARCH, "bf16", S))


def test_run_lm_end_to_end():
    r = lm_run(ARCH, "fp32", 32)
    toks = serve.run_lm(ARCH, device="cpu", params=r["lm"],
                        tokens=r["tokens"], gen=GEN)
    np.testing.assert_array_equal(toks.numpy(), r["ref_toks"])


def test_run_lm_defaults(capsys):
    toks = serve.run_lm(ARCH, device="cpu")
    assert tuple(toks.shape) == (2, 16)
    assert int(toks.min()) >= 0 and int(toks.max()) < 256
    assert f"[serve-lm] {ARCH}: generated 16x2 tokens" in \
        capsys.readouterr().out


@pytest.mark.parametrize("S", [16, 255])
def test_decode_matches_forward(S):
    """prefill + one decode step == full forward at position S (the port
    alone, bf16; at S = 255 the prefill runs one chunk of 255 and the
    forward one of 256)."""
    cfg = pcb.smoke(ARCH)
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
