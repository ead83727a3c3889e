"""The port's Mamba-2 SSD scan module vs the JAX reference, on the CPU.

``mamba2_ssd_cuda`` takes its plain PyTorch path here (the tensors lie on
the CPU); the CUDA kernels themselves are held against that plain path on
the card by ``chip_smoke.py`` (phase 6), stage by stage.  What the CPU can
check of the kernels' design is checked here:

  * ``plan`` sends the serving, smoke and edge shapes to the right path;
  * the precision argument of the staged path: its fp32 factors (the
    scores times decay and dt, the carried state, x dt w) enter bf16
    tensor-core products split into hi and lo parts.  Emulated in fp64 on
    small shapes, a single bf16 rounding of those factors misses the
    first-call bound ``SSD_REL`` of ``chip_smoke.py`` (relative Frobenius
    error, 1e-4) and the split meets it, against the fp64 result;
  * the plain version's staged intermediates (chunk states, totals,
    passed states) against the reference's sequential recurrence run
    over one chunk and over each prefix, and its y and state against the
    Pallas kernel in interpret mode (atol 2e-4, rtol 1e-3, the reference
    tests' bounds);
  * the wrapper's argument checks, on ``meta`` tensors, and its C
    signatures against ``csrc/mamba2_ssd.cu``.
"""
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as R
from repro.kernels.mamba2_ssd import mamba2_ssd_pallas
from repro_torch.kernels import mamba2_ssd as SSD

ROOT = pathlib.Path(__file__).resolve().parents[1]
ATOL, RTOL = 2e-4, 1e-3
SSD_REL = float(re.search(r"^SSD_REL = (\S+)", (ROOT / "chip_smoke.py")
                          .read_text(), re.M).group(1))


def _t(x):
    return torch.from_numpy(np.array(x))          # a writable copy


def _inputs(shape, seed=0):
    """x, dt, A, B, C as numpy fp32, with the distributions of the smoke
    test's inputs: x ~ N(0, 1), B and C ~ 0.3 N(0, 1), dt = 0.1
    softplus(N(0, 1)), A = -softplus(N(0, 1))."""
    Bt, L, H, P, N = shape[:5]
    rng = np.random.default_rng(seed + L + P + N)
    x = rng.normal(size=(Bt, L, H, P)).astype(np.float32)
    dt = (np.log1p(np.exp(rng.normal(size=(Bt, L, H)))) * 0.1
          ).astype(np.float32)
    A = (-np.log1p(np.exp(rng.normal(size=(H,))))).astype(np.float32)
    Bm = (rng.normal(size=(Bt, L, N)) * 0.3).astype(np.float32)
    Cm = (rng.normal(size=(Bt, L, N)) * 0.3).astype(np.float32)
    return x, dt, A, Bm, Cm


# ---------------------------------------------------------------------------
# plan
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("P,N,chunk,aligned,path", [
    (64, 64, 256, True, "staged"),     # zamba2's serving shape
    (16, 16, 32, True, "staged"),      # the smoke config (S = 32)
    (32, 16, 128, True, "staged"),
    (64, 32, 16, True, "staged"),      # the smallest chunk
    (64, 64, 256, False, "general"),   # a misaligned x, B or C
    (16, 16, 100, True, "general"),    # a chunk of 100: no multiple of 16
    (8, 4, 64, True, "general"),       # P = 8, N = 4
    (16, 8, 64, True, "general"),      # N = 8
    (48, 64, 256, True, "general"),    # P = 48: not instantiated
    (64, 64, 512, True, "general"),    # above the largest chunk
    (128, 128, 256, True, "general"),  # the widest general layout
])
def test_plan_chooses_the_path(P, N, chunk, aligned, path):
    assert SSD.plan(P, N, chunk, aligned) == path


def test_aligned_reads_addresses_and_row_strides():
    buf = torch.zeros((2, 64, 5 * 16 + 2 * 16), dtype=torch.bfloat16)
    x = buf[..., :80].reshape(2, 64, 5, 16)
    Bm, Cm = buf[..., 80:96], buf[..., 96:]
    assert SSD.aligned(x, Bm, Cm)               # the model's column slices
    assert not SSD.aligned(x, buf[..., 81:97], Cm)   # a 2-byte offset
    odd = torch.zeros((2, 64, 5 * 16 + 2 * 16 + 4), dtype=torch.bfloat16)
    assert not SSD.aligned(odd[..., :80].reshape(2, 64, 5, 16))  # row stride


# ---------------------------------------------------------------------------
# the precision of the staged path's products
# ---------------------------------------------------------------------------
def _bf16(v):
    return v.to(torch.bfloat16).to(torch.float64)


def _parts(v, split_it, mode):
    """The operand parts a product takes of ``v``: v as it is where the
    kernel does not round it; else bf16(v) ("single") or the hi and lo of
    its split ("split")."""
    if not split_it or mode == "exact":
        return [v]
    hi = _bf16(v)
    return [hi] if mode == "single" else [hi, _bf16(v - hi)]


def _mm(eq, a, b, sa, sb, mode):
    """einsum(eq, a, b) as the kernel's products take it: hi.hi, lo.hi and
    hi.lo of the parts (the lo.lo term is dropped)."""
    pa, pb = _parts(a, sa, mode), _parts(b, sb, mode)
    out = torch.einsum(eq, pa[0], pb[0])
    if len(pa) > 1:
        out = out + torch.einsum(eq, pa[1], pb[0])
    if len(pb) > 1:
        out = out + torch.einsum(eq, pa[0], pb[1])
    return out


def _emulated(x, dt, A, B, C, chunk, mode, fp32_inputs):
    """The staged path's algorithm in fp64, each tensor-core product taking
    its operands as ``mode`` says: the fp32 factors always, x, B and C
    too when they are fp32 (bf16 inputs are exact bf16 operands)."""
    Bt, L, H, P = x.shape
    N, c = B.shape[-1], chunk
    nc = L // c
    xc = x.reshape(Bt, nc, c, H, P)
    dtc = dt.reshape(Bt, nc, c, H)
    Bc, Cc = B.reshape(Bt, nc, c, N), C.reshape(Bt, nc, c, N)
    cum = torch.cumsum(dtc * A, dim=2)
    total = cum[:, :, -1]
    # (a) chunk states: (x dt w)^T B
    xf = xc * (dtc * torch.exp(total[:, :, None] - cum))[..., None]
    S = _mm("bjshp,bjsn->bjhpn", xf, Bc, True, fp32_inputs, mode)
    # (b) the states passed from chunk to chunk
    st = torch.zeros((Bt, H, P, N), dtype=torch.float64)
    passed = []
    for j in range(nc):
        passed.append(st)
        st = torch.exp(total[:, j])[..., None, None] * st + S[:, j]
    passed = torch.stack(passed, dim=1)
    # (c) y = ((C B^T o L) dt) x + exp(cum) C st^T
    G = _mm("bjtn,bjsn->bjts", Cc, Bc, fp32_inputs, fp32_inputs, mode)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    causal = torch.tril(torch.ones((c, c), dtype=torch.bool))[..., None]
    W = torch.where(causal, G[..., None] * torch.exp(
        seg.masked_fill(~causal, 0.0)) * dtc[:, :, None], 0.0)
    y = _mm("bjtsh,bjshp->bjthp", W, xc, True, fp32_inputs, mode)
    y = y + torch.exp(cum)[..., None] * _mm(
        "bjtn,bjhpn->bjthp", Cc, passed, fp32_inputs, True, mode)
    return y.reshape(Bt, L, H, P), st


def _rel(got, want):
    return float(torch.linalg.vector_norm(got - want)
                 / torch.linalg.vector_norm(want))


@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
@pytest.mark.parametrize("mode", ["single", "split"])
def test_split_factors_keep_the_ssd_tolerance(dtype, mode):
    """A single bf16 rounding of the fp32 factors misses SSD_REL; their hi
    and lo split meets it, and the reference tests' allclose bounds."""
    shape = (2, 512, 2, 32, 32, 256)
    x, dt, A, Bm, Cm = map(_t, _inputs(shape))
    if dtype == "bf16":                          # the serving dtype's inputs
        x, Bm, Cm = (v.bfloat16() for v in (x, Bm, Cm))
    args = [v.double() for v in (x, dt, A, Bm, Cm)]
    y0, st0 = _emulated(*args, shape[5], "exact", dtype == "fp32")
    y, st = _emulated(*args, shape[5], mode, dtype == "fp32")
    err = max(_rel(y, y0), _rel(st, st0))
    if mode == "single":
        assert err > SSD_REL, err
    else:
        assert err <= SSD_REL / 10, err
        for got, want in ((y, y0), (st, st0)):
            np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL,
                                       rtol=RTOL)


# ---------------------------------------------------------------------------
# the plain version's stages vs the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(2, 128, 3, 16, 16, 64),
                                   (1, 256, 2, 32, 16, 64),
                                   (2, 96, 2, 8, 4, 32)], ids=str)
def test_plain_stages_match_the_reference(shape):
    """Chunk j's state is the recurrence run over chunk j alone from 0; the
    state passed into chunk j is the recurrence's final state over the
    first j chunks; y and the final state are the Pallas kernel's."""
    args = _inputs(shape)
    x, dt, A, Bm, Cm = args
    c = shape[5]
    y, st, stages = SSD.mamba2_ssd_plain(*map(_t, args), chunk=c,
                                         stages=True)
    y0, st0 = SSD.mamba2_ssd_plain(*map(_t, args), chunk=c)
    assert torch.equal(y, y0) and torch.equal(st, st0)
    Bt, L, H, P = x.shape
    nc = L // c
    assert stages["chunk_state"].shape == (Bt, nc, H, P, shape[4])
    assert stages["passed_state"].shape == (Bt, nc, H, P, shape[4])
    assert stages["chunk_total"].shape == (Bt, nc, H)

    def recurrence(lo, hi):
        s = slice(lo, hi)
        return np.asarray(R.mamba2_ssd_ref(
            *map(jnp.asarray, (x[:, s], dt[:, s], A, Bm[:, s], Cm[:, s])))[1])

    for j in range(nc):
        np.testing.assert_allclose(stages["chunk_state"][:, j].numpy(),
                                   recurrence(j * c, (j + 1) * c),
                                   atol=ATOL, rtol=RTOL)
        want = recurrence(0, j * c) if j else np.zeros_like(st.numpy())
        np.testing.assert_allclose(stages["passed_state"][:, j].numpy(),
                                   want, atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(
            stages["chunk_total"][:, j].numpy(),
            (dt[:, j * c:(j + 1) * c] * A).sum(axis=1), atol=1e-5, rtol=1e-5)
    y_k, st_k = mamba2_ssd_pallas(*map(jnp.asarray, args), chunk=c,
                                  interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_k), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(st_k), atol=ATOL,
                               rtol=RTOL)


def test_cpu_wrapper_returns_the_plain_stages():
    args = list(map(_t, _inputs((2, 128, 2, 16, 16))))
    before = (SSD.launches, SSD.last_plan)
    y, st, stages = SSD.mamba2_ssd_cuda(*args, chunk=64, stages=True)
    want = SSD.mamba2_ssd_plain(*args, chunk=64, stages=True)
    assert (SSD.launches, SSD.last_plan) == before  # the CPU launches nothing
    assert torch.equal(y, want[0]) and torch.equal(st, want[1])
    for name, t in stages.items():
        assert torch.equal(t, want[2][name]), name


# ---------------------------------------------------------------------------
# the wrapper's checks and the C interface
# ---------------------------------------------------------------------------
def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _meta_args(Bt=1, L=64, H=2, P=16, N=16, dtype=torch.float32):
    return [_meta((Bt, L, H, P), dtype), _meta((Bt, L, H)), _meta((H,)),
            _meta((Bt, L, N), dtype), _meta((Bt, L, N), dtype)]


def _mixed():
    a = _meta_args()
    a[0] = a[0].bfloat16()
    return a


def _bf16_dt():
    a = _meta_args(dtype=torch.bfloat16)
    a[1] = a[1].bfloat16()
    return a


def _strided_x():
    a = _meta_args()
    a[0] = _meta((1, 64, 16, 2)).transpose(2, 3)     # P not contiguous
    return a


@pytest.mark.parametrize("make,chunk,match", [
    (_mixed, 256, "all fp32 or all bf16"),
    (_bf16_dt, 256, "dt and A must be fp32"),
    (lambda: _meta_args(P=130), 256, "above the kernel's"),
    (_strided_x, 256, "must be contiguous"),
    (lambda: _meta_args(L=16 * 65536, H=1), 16, "for the grid"),
    (lambda: _meta_args(Bt=65536, L=16, H=1), 16, "for the grid"),
    (lambda: _meta_args(), 256, "no kernel for device meta"),
    (lambda: _meta_args(dtype=torch.bfloat16), 32, "no kernel for device"),
], ids=["mixed", "bf16-dt", "P=130", "strided-x", "chunks", "sequences",
        "fp32", "bf16"])
def test_kernel_argument_checks_on_meta(make, chunk, match):
    """Off the CPU the wrapper checks what either CUDA path takes before it
    looks for a kernel; a meta tensor that passes reaches no kernel."""
    with pytest.raises(ValueError, match=match):
        SSD.mamba2_ssd_cuda(*make(), chunk=chunk)


def _c_params(src: str, name: str) -> list:
    """The parameters of ``name(...) {`` in a C source, as written."""
    m = re.search(r"\b" + name + r"\(([^)]*)\)\s*\{", src)
    assert m, name
    return [p.strip() for p in m.group(1).split(",") if p.strip()]


def test_c_interface_matches_the_wrapper():
    """Each C function of csrc/mamba2_ssd.cu takes as many arguments, of the
    same kinds, as the ctypes signature the wrapper sets (a mismatch would
    only show on the card), and the staged path's limits in the wrapper
    are the kernel's."""
    import ctypes
    src = (ROOT / "src/repro_torch/kernels/csrc/mamba2_ssd.cu").read_text()
    for name, (args, _) in SSD._SIGNATURES.items():
        params = _c_params(src, name)
        assert len(params) == len(args), (name, params)
        for p, a in zip(params, args):
            want = "pointer" if "*" in p else "int"
            assert ("int" if a is ctypes.c_int else "pointer") == want, \
                (name, p, a)
    dims = re.search(r"#define SSD_STAGED_DIMS\(X\) (.*)", src).group(1)
    assert tuple(int(d) for d in re.findall(r"X\((\d+)\)", dims)) == \
        SSD.STAGED_DIMS
    assert int(re.search(r"constexpr int kMaxChunk = (\d+);", src)
               .group(1)) == SSD.STAGED_MAX_CHUNK
