"""The port's LM serving path (dense and hybrid families) vs the JAX
reference, on the CPU; and that every arch of the reference is ported.

Here ``flash_attention_cuda`` and ``mamba2_ssd_cuda`` take their plain
PyTorch path (the tensors lie on the CPU); the CUDA kernels themselves are
held against those plain paths on the card by ``chip_smoke.py``.  Inputs
are made from a seed with numpy and handed to both sides; weights are the
reference's own (``init_params`` with a fixed key), carried across by
``convert.lm_params``.

Oracles and tolerances:
  * flash plain version vs ``flash_attention_pallas(interpret=True)``:
    fp32 atol 2e-5, rtol 1e-4; bf16 0.05 max abs (``test_kernels.py``'s
    own bounds).  Causal masks are left-aligned in both (ROADMAP R4), so
    an Sq < Sk case is held against the Pallas kernel, not its oracle.
  * SSD plain version vs ``mamba2_ssd_pallas(interpret=True)`` and
    ``mamba2_ssd_ref``: y and the final state, atol 2e-4, rtol 1e-3.
  * modules and whole models in fp32: 1e-5 max abs (the same math in the
    same type; only summation orders differ).  Greedy tokens equal.
  * whole models in bf16, teacher-forced on the reference's tokens: every
    step's logits within 2e-2 of max |logit| (``test_archs.py``'s bound):
    the two frameworks round bf16 intermediates at different places.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as cb
from repro.kernels import ref as R
from repro.kernels.flash_attention import flash_attention_pallas
from repro.kernels.mamba2_ssd import mamba2_ssd_pallas
from repro.launch import specs as rsp
from repro.models import attention as RA
from repro.models import layers as RL
from repro.models import model as rm
from repro.models import ssm as RS
from repro.sharding import init_params
from repro_torch import convert
from repro_torch.configs import base as pcb
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import mamba2_ssd as SSD
from repro_torch.kernels import ops as K
from repro_torch.kernels import ref as PR
from repro_torch.launch import serve
from repro_torch.launch import specs as psp
from repro_torch.models import attention as PA
from repro_torch.models import layers as PL
from repro_torch.models import model as pm
from repro_torch.models import ssm as PS
from repro_torch.models.params import Spec, init_params as p_init_params

ARCHS = ["zamba2-2.7b", "tinyllama-1.1b", "codeqwen1.5-7b", "starcoder2-15b"]
B, GEN = 2, 16
TOL = 1e-5
BF16_REL = 2e-2


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Run this file's torch ops on one core: the other test workers share
    the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x))          # a writable copy


def _np(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32))


def _rel(ref, got):
    ref, got = _np(ref), _np(got)
    return float(np.abs(ref - got).max() / (np.abs(ref).max() + 1e-6))


# ---------------------------------------------------------------------------
# flash attention: the plain version vs the Pallas kernel
# ---------------------------------------------------------------------------
FLASH = [  # B, H, Kh, Sq, Sk, D, Dv, causal, window
    (1, 2, 2, 128, 128, 64, 64, True, 0),
    (2, 4, 2, 256, 256, 64, 64, True, 0),       # GQA group 2
    (1, 8, 1, 512, 512, 128, 128, True, 0),     # MQA
    (2, 2, 2, 256, 256, 64, 64, False, 0),      # bidirectional
    (1, 4, 4, 512, 512, 64, 64, True, 128),     # sliding window
    (1, 2, 2, 384, 384, 32, 32, True, 0),       # non-multiple of block
    (1, 2, 2, 256, 256, 192, 128, True, 0),     # MLA head dims
    (1, 4, 2, 512, 512, 80, 80, True, 0),       # zamba2's head dim, GQA
    (2, 4, 2, 100, 300, 64, 64, True, 0),       # Sq < Sk: left-aligned
]


def _flash_inputs(shape, dtype=np.float32, seed=0):
    Bq, H, Kh, Sq, Sk, D, Dv = shape[:7]
    rng = np.random.default_rng(seed + Sq + H)
    q = (rng.normal(size=(Bq, H, Sq, D)) * 0.3).astype(np.float32)
    k = (rng.normal(size=(Bq, Kh, Sk, D)) * 0.3).astype(np.float32)
    v = rng.normal(size=(Bq, Kh, Sk, Dv)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("shape", FLASH, ids=str)
def test_flash_plain_vs_pallas(shape):
    causal, window = shape[7], shape[8]
    q, k, v = _flash_inputs(shape)
    want = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=causal,
                                  window=window, bq=128, bk=128,
                                  interpret=True)
    got = FA.flash_attention_cuda(_t(q), _t(k), _t(v), causal=causal,
                                  window=window)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=1e-4)


@pytest.mark.parametrize("shape", [(1, 2, 2, 256, 256, 64, 64),
                                   (1, 4, 2, 512, 512, 80, 80)], ids=str)
def test_flash_plain_vs_pallas_bf16(shape):
    q, k, v = (x.astype(jnp.bfloat16) for x in _flash_inputs(shape))
    want = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), interpret=True)
    got = FA.flash_attention_cuda(*(_t(x.astype(np.float32)).bfloat16()
                                    for x in (q, k, v)))
    assert got.dtype == torch.bfloat16
    assert float(np.abs(_np(got) - _np(want)).max()) < 0.05


def test_flash_oracles_agree_and_pin_alignment():
    """The port's oracle is the reference's (right-aligned); at Sq < Sk it
    differs from the kernel's left-aligned causal mask (ROADMAP R4), which
    the plain version follows."""
    shape = (2, 4, 2, 100, 300, 64, 64)
    q, k, v = _flash_inputs(shape)
    want = R.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v))
    got = PR.flash_attention_ref(_t(q), _t(k), _t(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=1e-4)
    plain = FA.flash_attention_plain(_t(q), _t(k), _t(v))
    assert float((plain - got).abs().max()) > 0.1
    w = PR.flash_attention_ref(_t(q), _t(k), _t(v), window=64)
    np.testing.assert_allclose(
        w.numpy(), np.asarray(R.flash_attention_ref(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=64)),
        atol=2e-5, rtol=1e-4)


def _attn_head_dims(cfg):
    """(D, Dv) of the attention a config runs through the flash kernel:
    qk_nope + qk_rope and v_head_dim for MLA, head_dim for the others."""
    if cfg.attn_kind == "mla":
        return (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim, cfg.v_head_dim)
    return (cfg.dh, cfg.dh)


# every full-width config whose family attends with softmax; xLSTM's mLSTM
# does not go through the flash kernel
ATTN_ARCHS = [a for a in cb.ARCH_IDS if cb.get(a).block_kind != "xlstm"]


@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_flash_kernel_takes_every_reference_head_dim(arch):
    """No full-width config can reach the kernel's head-dim raise on the
    card unannounced."""
    D, Dv = _attn_head_dims(cb.get(arch))
    assert (D, Dv) in FA.supported_head_dims(), (arch, D, Dv)
    assert D % 16 == 0 and Dv % 16 == 0 and max(D, Dv) <= 256


@pytest.mark.parametrize("arch", ARCHS)
def test_flash_kernel_takes_the_smoke_head_dims(arch):
    """``run_lm(arch)`` serves the port's smoke config by default, on the
    card: its head dims must have a kernel too."""
    cfg = pcb.smoke(arch)
    assert (cfg.dh, cfg.dh) in FA.supported_head_dims(), (arch, cfg.dh)


def test_flash_kernel_head_dims_are_every_multiple_of_16():
    """The kernel is instantiated for every multiple of 16 up to 256 with
    Dv = D, and for MLA's 192 / 128, each pair once."""
    pairs = FA.supported_head_dims()
    assert len(set(pairs)) == len(pairs)
    assert set(pairs) == {(d, d) for d in range(16, 257, 16)} | {(192, 128)}


@pytest.mark.parametrize("D", [8, 16, 24])
def test_flash_cpu_takes_any_head_dim(D):
    """The CPU path (the plain version) takes any head dim and agrees with
    the reference's oracle there; the CUDA path's checks refuse a head dim
    that is no multiple of 16 (and misaligned rows) before any library
    loads."""
    q, k, v = _flash_inputs((1, 4, 2, 48, 48, D, D))
    got = FA.flash_attention_cuda(_t(q), _t(k), _t(v))
    want = R.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=1e-4)
    assert ((D, D) in FA.supported_head_dims()) == (D % 16 == 0)
    if D % 16:
        with pytest.raises(ValueError, match="head dims"):
            FA._flash_cuda(_t(q), _t(k), _t(v), True, 0)
    q, k, v = (_t(x).bfloat16() for x in
               _flash_inputs((1, 2, 2, 16, 16, 65, 64)))
    with pytest.raises(ValueError, match="16-byte"):
        FA._flash_cuda(q[..., 1:], k[..., 1:], v, True, 0)


# ---------------------------------------------------------------------------
# Mamba-2 SSD: the plain version vs the Pallas kernel and the oracle
# ---------------------------------------------------------------------------
SSD_SHAPES = [  # Bt, L, H, P, N, chunk
    (1, 128, 1, 16, 8, 64),
    (2, 256, 3, 32, 16, 128),
    (1, 512, 2, 64, 32, 256),
    (2, 64, 4, 8, 8, 64),              # single chunk
    (2, 1024, 2, 16, 8, 256),          # four chunks
]


def _ssd_inputs(shape, seed=0):
    Bt, L, H, P, N = shape[:5]
    rng = np.random.default_rng(seed + L + P)
    x = rng.normal(size=(Bt, L, H, P)).astype(np.float32)
    dt = (np.log1p(np.exp(rng.normal(size=(Bt, L, H)))) * 0.1
          ).astype(np.float32)
    A = (-np.log1p(np.exp(rng.normal(size=(H,))))).astype(np.float32)
    Bm = (rng.normal(size=(Bt, L, N)) * 0.3).astype(np.float32)
    Cm = (rng.normal(size=(Bt, L, N)) * 0.3).astype(np.float32)
    return x, dt, A, Bm, Cm


@pytest.mark.parametrize("shape", SSD_SHAPES, ids=str)
def test_ssd_plain_vs_pallas_and_ref(shape):
    args = _ssd_inputs(shape)
    chunk = shape[5]
    y_k, st_k = mamba2_ssd_pallas(*map(jnp.asarray, args), chunk=chunk,
                                  interpret=True)
    y_r, st_r = R.mamba2_ssd_ref(*map(jnp.asarray, args))
    y, st = SSD.mamba2_ssd_cuda(*map(_t, args), chunk=chunk)
    assert y.dtype == st.dtype == torch.float32
    for want_y, want_st in ((y_k, st_k), (y_r, st_r)):
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y), atol=2e-4,
                                   rtol=1e-3)
        np.testing.assert_allclose(st.numpy(), np.asarray(want_st),
                                   atol=2e-4, rtol=1e-3)


def test_ssd_oracles_agree_with_skip_and_initial_state():
    x, dt, A, Bm, Cm = _ssd_inputs((2, 64, 3, 8, 4))
    rng = np.random.default_rng(5)
    D = rng.normal(size=(3,)).astype(np.float32)
    h0 = rng.normal(size=(2, 3, 8, 4)).astype(np.float32)
    y_r, st_r = R.mamba2_ssd_ref(*map(jnp.asarray, (x, dt, A, Bm, Cm)),
                                 jnp.asarray(D), init_state=jnp.asarray(h0))
    y, st = PR.mamba2_ssd_ref(*map(_t, (x, dt, A, Bm, Cm)), _t(D),
                              init_state=_t(h0))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_r), atol=2e-5,
                               rtol=1e-4)
    np.testing.assert_allclose(st.numpy(), np.asarray(st_r), atol=2e-5,
                               rtol=1e-4)


def test_kernel_wrappers_check_and_count():
    q, k, v = map(_t, _flash_inputs((1, 2, 2, 16, 16, 8, 8)))
    x, dt, A, Bm, Cm = map(_t, _ssd_inputs((1, 32, 2, 4, 4)))
    before = (FA.launches, SSD.launches)
    K.flash_attention(q, k, v)
    K.mamba2_ssd(x, dt, A, Bm, Cm)
    assert (FA.launches, SSD.launches) == before   # the CPU launches nothing
    with pytest.raises(ValueError):
        FA.flash_attention_cuda(q, k[:, :, :, :4], v)          # D mismatch
    with pytest.raises(ValueError):
        FA.flash_attention_cuda(q, k.double(), v)              # dtypes
    with pytest.raises(ValueError):
        SSD.mamba2_ssd_cuda(x, dt, A, Bm, Cm, chunk=5)         # L % chunk
    with pytest.raises(ValueError):
        SSD.mamba2_ssd_cuda(x, dt[:, :, :1], A, Bm, Cm)        # shapes
    # a device with no kernel raises: there is no fallback to the plain path
    with pytest.raises(ValueError):
        FA.flash_attention_cuda(q.to("meta"), k.to("meta"), v.to("meta"))
    with pytest.raises(ValueError):
        SSD.mamba2_ssd_cuda(*(t.to("meta") for t in (x, dt, A, Bm, Cm)))


# ---------------------------------------------------------------------------
# configs and specs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_copy_the_reference(arch):
    assert dataclasses.asdict(pcb.get(arch)) == \
        dataclasses.asdict(cb.get(arch))
    assert dataclasses.asdict(pcb.smoke(arch)) == \
        dataclasses.asdict(cb.smoke(arch))


@pytest.mark.parametrize("arch", cb.ARCH_IDS)
def test_every_arch_is_ported(arch):
    """Every arch of the reference resolves in the port, to the reference's
    full and smoke configs, and its parameter and cache specs build as the
    reference's (nothing allocated)."""
    assert pcb.PORTED == cb.ARCH_IDS == pcb.ARCH_IDS
    assert pm.FAMILIES == ("dense", "vlm", "hybrid", "moe", "gemma3", "ssm",
                           "audio")
    for pick in ("get", "smoke"):
        cfg, pcfg = getattr(cb, pick)(arch), getattr(pcb, pick)(arch)
        assert dataclasses.asdict(pcfg) == dataclasses.asdict(cfg)
        assert _shapes(pm.param_specs(pcfg)) == _shapes(rm.param_specs(cfg))
        assert _shapes(pm.cache_specs(pcfg, 2, 9)) == \
            _shapes(rm.cache_specs(cfg, 2, 9))


@pytest.mark.parametrize("arch", ["codeqwen1.5-7b", "deepseek-v2-236b",
                                  "gemma3-12b"])
def test_int8_cache_specs_build(arch):
    """``kv_cache_dtype="int8"``: the GQA (full and ring) and MLA cache
    specs are the reference's, int8 rows with fp32 scales."""
    cfg = cb.smoke(arch).replace(kv_cache_dtype="int8")
    pcfg = pcb.smoke(arch).replace(kv_cache_dtype="int8")
    got, want = _shapes(pm.cache_specs(pcfg, 2, 9)), \
        _shapes(rm.cache_specs(cfg, 2, 9))
    assert got == want
    assert {"int8", "float32"} <= {v[1] for v in got.values()}


def _dtype_name(dt):
    if dt is None:
        return None
    if isinstance(dt, torch.dtype):
        return str(dt).split(".")[-1]
    return jnp.dtype(dt).name


def _shapes(tree):
    """(shape, dtype) of each leaf of a spec tree keyed by path, the port's
    lists of blocks stacked back into the reference's leading axes."""
    out = {}

    def walk(t, path, lead):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (k,), lead)
        elif isinstance(t, list):
            walk(t[0], path, lead + (len(t),))
        else:
            out[path] = (lead + tuple(t.shape), _dtype_name(t.dtype), t.init)
    walk(tree, (), ())
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_match_the_reference(arch):
    cfg, pcfg = cb.smoke(arch), pcb.smoke(arch)
    assert _shapes(pm.param_specs(pcfg)) == _shapes(rm.param_specs(cfg))
    assert _shapes(pm.cache_specs(pcfg, 2, 9)) == \
        _shapes(rm.cache_specs(cfg, 2, 9))


def test_full_zamba2_size():
    """2.4 B parameters, counted from the specs (nothing allocated)."""
    n = 0

    def count(t):
        nonlocal n
        if isinstance(t, dict):
            [count(v) for v in t.values()]
        elif isinstance(t, list):
            [count(v) for v in t]
        else:
            n += int(np.prod(t.shape))
    count(pm.param_specs(pcb.get("zamba2-2.7b")))
    assert 2.3e9 < n < 2.5e9, n


def test_init_params_kinds_and_dtypes():
    specs = {"w": Spec((400, 300), ("a", "b")),
             "s": Spec((4000,), ("a",), "small"),
             "z": Spec((3,), ("a",), "zeros"),
             "o": Spec((3,), ("a",), "ones", torch.float32)}
    g = torch.Generator().manual_seed(0)
    p = p_init_params(specs, g, torch.bfloat16)
    assert p["w"].dtype == torch.bfloat16 and p["o"].dtype == torch.float32
    assert abs(float(p["w"].float().std()) - 0.02) < 1e-3
    assert abs(float(p["s"].float().std()) - 0.006) < 5e-4
    assert bool((p["z"] == 0).all()) and bool((p["o"] == 1).all())
    lm = pm.init(pcb.smoke("zamba2-2.7b"), torch.Generator().manual_seed(0))
    mp = lm.blocks[0]["mamba"][0]
    assert {mp[n].dtype for n in ("A_log", "D", "dt_bias")} == \
        {torch.float32}
    assert lm.dtype == torch.bfloat16 and mp["w_in"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# modules, fp32, the reference's weights
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def smoke_models():
    """{arch: (cfg, reference params, port LM)} in fp32."""
    out = {}
    for arch in ARCHS:
        cfg = cb.smoke(arch)
        params = init_params(rm.param_specs(cfg), jax.random.PRNGKey(0),
                             jnp.float32)
        out[arch] = (cfg, params, convert.lm_params(
            pcb.smoke(arch), jax.tree.map(np.asarray, params)))
    return out


def _x(cfg, S=32, seed=1):
    return np.random.default_rng(seed).normal(
        size=(B, S, cfg.d_model)).astype(np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=0)


def test_layers_match_reference(smoke_models):
    cfg, params, lm = smoke_models["tinyllama-1.1b"]
    x = _x(cfg)
    w = np.random.default_rng(2).normal(size=(cfg.d_model,)) \
        .astype(np.float32) * 0.1
    _close(PL.rms_norm(_t(x), _t(w)), RL.rms_norm(jnp.asarray(x),
                                                   jnp.asarray(w)))
    xh = x.reshape(B, 32, 4, 16)
    pos = np.arange(32)
    _close(PL.apply_rope(_t(xh), _t(pos), 1e4),
           RL.apply_rope(jnp.asarray(xh), jnp.asarray(pos), 1e4))
    pos2 = np.stack([pos, pos + 7])
    _close(PL.apply_rope(_t(xh), _t(pos2), 500.0),
           RL.apply_rope(jnp.asarray(xh), jnp.asarray(pos2), 500.0))
    _close(PL.mlp_fwd(lm.blocks[0]["mlp"], _t(x)),
           RL.mlp_fwd(jax.tree.map(lambda a: a[0], params["blocks"]["mlp"]),
                      jnp.asarray(x)))
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (B, 32))
    _close(PL.embed(lm.embed, _t(toks), 2560),
           RL.embed(params["embed"], jnp.asarray(toks), 2560))
    _close(PL.unembed(lm.embed, _t(x)), RL.unembed(params["embed"],
                                                   jnp.asarray(x)))
    assert PL.embed_scale(2560) == 50.5


@pytest.mark.parametrize("arch", ARCHS)
def test_gqa_fwd_and_step_match_reference(smoke_models, arch):
    cfg, params, lm = smoke_models[arch]
    if cfg.family == "dense":
        rp, pp = jax.tree.map(lambda a: a[0], params["blocks"]["attn"]), \
            lm.blocks[0]["attn"]
    else:
        rp, pp = params["shared"]["attn"], lm.shared["attn"]
    x = _x(cfg)
    y_r, c_r = RA.gqa_fwd(rp, jnp.asarray(x), cfg, theta=cfg.rope_theta,
                          want_cache=True)
    y, c = PA.gqa_fwd(pp, _t(x), cfg, theta=cfg.rope_theta, want_cache=True)
    _close(y, y_r)
    for key in ("k", "v", "pos"):
        _close(c[key], c_r[key])
    # one step against a 40-slot cache holding the prefix
    T, S = 40, 32
    ck = np.zeros((B, T) + c_r["k"].shape[2:], np.float32)
    cv, cpos = ck.copy(), np.full((B, T), 1 << 30, np.int32)
    ck[:, :S], cv[:, :S], cpos[:, :S] = c_r["k"], c_r["v"], c_r["pos"]
    x1 = _x(cfg, S=1, seed=4)
    cache_r = {"k": jnp.asarray(ck), "v": jnp.asarray(cv),
               "pos": jnp.asarray(cpos)}
    y_r, nc_r = RA.gqa_step(rp, jnp.asarray(x1), cfg, cache_r, jnp.int32(S),
                            theta=cfg.rope_theta)
    cache = {"k": _t(ck), "v": _t(cv), "pos": _t(cpos)}
    y, nc = PA.gqa_step(pp, _t(x1), cfg, cache, S, theta=cfg.rope_theta)
    _close(y, y_r)
    for key in ("k", "v", "pos"):
        _close(nc[key], nc_r[key])


def test_mamba2_fwd_and_step_match_reference(smoke_models):
    cfg, params, lm = smoke_models["zamba2-2.7b"]
    rp = jax.tree.map(lambda a: a[0, 1], params["blocks"]["mamba"])
    pp = lm.blocks[0]["mamba"][1]
    for S in (32, 512):                     # one chunk, two chunks of 256
        x = _x(cfg, S=S)
        y_r, c_r = RS.mamba2_fwd(rp, jnp.asarray(x), cfg, want_cache=True)
        y, c = PS.mamba2_fwd(pp, _t(x), cfg, want_cache=True)
        _close(y, y_r)
        _close(c["conv"], c_r["conv"])
        _close(c["h"], c_r["h"])
    x1 = _x(cfg, S=1, seed=5)
    y_r, nc_r = RS.mamba2_step(rp, jnp.asarray(x1), cfg, c_r)
    y, nc = PS.mamba2_step(pp, _t(x1), cfg,
                           {k: v.clone() for k, v in c.items()})
    _close(y, y_r)
    _close(nc["conv"], nc_r["conv"])
    _close(nc["h"], nc_r["h"])


# ---------------------------------------------------------------------------
# the slice as a whole: prefill, then greedy decode
# ---------------------------------------------------------------------------
def _put_jax(dst, src):
    if src.ndim == 0 or dst.shape == src.shape:
        return src.astype(dst.dtype)
    ax = [i for i, (a, b) in enumerate(zip(dst.shape, src.shape))
          if a != b][0]
    sl = [slice(None)] * dst.ndim
    sl[ax] = slice(0, src.shape[ax])
    return dst.at[tuple(sl)].set(src.astype(dst.dtype))


def _stack(cfg, cache):
    """The port's per-block cache list as the reference's stacked tree."""
    st = lambda xs: np.stack([_np(x) for x in xs])  # noqa: E731
    if cfg.family == "dense":
        return {"attn": {k: st([c["attn"][k] for c in cache])
                         for k in cache[0]["attn"]}}
    return {"mamba": {k: st([st([m[k] for m in c["mamba"]]) for c in cache])
                      for k in cache[0]["mamba"][0]},
            "shared": {k: st([c["shared"][k] for c in cache])
                       for k in cache[0]["shared"]}}


def _flat(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, path + (k,)))
        return out
    return {path: _np(tree)}


_RUNS = {}


def lm_run(arch, dtype, S):
    """Both sides on the same weights and prompt: prefill, then GEN - 1
    decode steps.  fp32 decodes greedily on each side; bf16 feeds the
    reference's greedy tokens to both (teacher forcing).  Returns a dict of
    numpy results (cached per argument)."""
    key = (arch, dtype, S)
    if key in _RUNS:
        return _RUNS[key]
    cfg, pcfg = cb.smoke(arch), pcb.smoke(arch)
    jdt = jnp.float32 if dtype == "fp32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "fp32" else torch.bfloat16
    params = init_params(rm.param_specs(cfg), jax.random.PRNGKey(0), jdt)
    lm = convert.lm_params(pcfg, jax.tree.map(np.asarray, params))
    toks = np.random.default_rng(S).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    T = S + GEN
    # the reference, as run_lm runs it (caches in the weights' dtype)
    last, cache = jax.jit(lambda p, b: rm.prefill(p, cfg, b))(
        params, {"tokens": jnp.asarray(toks)})
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
        plast, pcache = pm.prefill(lm, pcfg, {"tokens": _t(toks)})
        port_prefill_cache = _stack(pcfg, pcache)
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
        _flat(port_prefill_cache), "lm": lm, "tokens": toks}
    return out


@pytest.mark.parametrize("S", [32, 512])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_fp32_matches_reference(arch, S):
    r = lm_run(arch, "fp32", S)
    _close(r["port_logits"][0], r["ref_logits"][0])
    assert r["port_cache"].keys() == r["ref_cache"].keys()
    for k, want in r["ref_cache"].items():
        _close(r["port_cache"][k], want)


@pytest.mark.parametrize("S", [32, 512])
@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_decode_fp32_matches_reference(arch, S):
    r = lm_run(arch, "fp32", S)
    np.testing.assert_array_equal(r["port_toks"], r["ref_toks"])
    for got, want in zip(r["port_logits"], r["ref_logits"]):
        _close(got, want)


@pytest.mark.parametrize("S", [32, 512])
@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_teacher_forced_logits_match_reference(arch, S):
    r = lm_run(arch, "bf16", S)
    assert len(r["port_logits"]) == GEN
    for got, want in zip(r["port_logits"], r["ref_logits"]):
        assert _rel(want, got) < BF16_REL


@pytest.mark.parametrize("arch", ARCHS)
def test_run_lm_end_to_end(arch):
    """``run_lm`` on the CPU with the reference's weights and prompt gives
    the reference's greedy tokens (fp32 weights and caches)."""
    r = lm_run(arch, "fp32", 32)
    toks = serve.run_lm(arch, device="cpu", params=r["lm"],
                        tokens=r["tokens"], gen=GEN)
    assert toks.dtype == torch.int32 and tuple(toks.shape) == (B, GEN)
    np.testing.assert_array_equal(toks.numpy(), r["ref_toks"])


def test_run_lm_defaults_and_main(capsys):
    toks = serve.run_lm(device="cpu")
    assert tuple(toks.shape) == (2, 16)
    assert int(toks.min()) >= 0 and int(toks.max()) < 256
    serve.main(["--mode", "lm", "--arch", "zamba2-2.7b", "--device", "cpu"])
    assert "[serve-lm] zamba2-2.7b: generated 16x2 tokens" in \
        capsys.readouterr().out


def test_run_lm_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.run_lm()


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """prefill + one decode step == full forward at position S (the
    port's copy of ``test_archs.py``'s check, on the port alone)."""
    S = 16
    cfg = pcb.smoke(arch)
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
