"""The backward kernels' CPU side: what the card checks stand on.

The kernels themselves (``csrc/flash_attention_bwd.cu``,
``csrc/mamba2_ssd_bwd.cu``) run only on the card
(``tests/test_torch_backward_cuda.py``, marked ``cuda``, and
``chip_smoke.py`` phases 5, 6 and 12).  Here:
  * ``flash_lse_plain``, what the forward's ``lse`` output is held
    against on the card, vs a logsumexp of the reference's masked fp32
    scores (``jax.numpy``, the masks written out left-aligned as the
    port's contract states, ROADMAP R4) on the same seeded numpy inputs,
    within 1e-5 (fp32 summation orders), and NEG exactly on a row that no
    key is visible to;
  * ``mamba2_ssd.plan_backward`` and ``flash_attention.plan_backward`` at
    their boundaries, and their shared-memory sums against the sources';
  * the split-bf16 products of the tensor-core paths (hi = bf16(x),
    lo = bf16(x - hi), hi.hi + hi.lo + lo.hi), emulated in plain torch
    against float64: the flash backward's five products and one SSD
    chunk's G, R and dxdt, within a tenth of the fp32 bounds;
  * the backward operators' fakes give the plain backwards' shapes and
    dtypes, and the dry run's counter sees one backward operator a call;
  * the flash wrapper's padding of head dims the kernels have no
    instance for, with a plain stand-in for the kernel: the gradients cut
    back equal the unpadded plain backward's;
  * each C function of the backward sources takes the arguments the
    ctypes signatures give it.
"""
import ctypes
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import mamba2_ssd as SSD
from repro_torch.kernels import trace
from repro_torch.launch.op_stats import OpCounter
from test_torch_lm import FLASH, _flash_inputs

ROOT = pathlib.Path(__file__).resolve().parents[1]
CSRC = ROOT / "src/repro_torch/kernels/csrc"
LSE_TOL = 1e-5
# rows that no key is visible to: a window with Sq >= Sk + window
BLIND = [(1, 4, 2, 96, 32, 16, 16, True, 16),
         (2, 2, 2, 80, 24, 32, 32, False, 8)]


def _ref_lse(q, k, causal, window):
    """The reference's masked fp32 scores' logsumexp, left-aligned masks,
    NEG where masked (``flash_attention_ref``'s fill)."""
    B, H, Sq, D = q.shape
    Kh, Sk = k.shape[1], k.shape[2]
    qg = jnp.asarray(q).reshape(B, Kh, H // Kh, Sq, D)
    s = jnp.einsum("bkgqd,bksd->bkgqs", qg, jnp.asarray(k)) * D ** -0.5
    qp, kp = jnp.arange(Sq)[:, None], jnp.arange(Sk)[None, :]
    m = jnp.ones((Sq, Sk), bool)
    if causal:
        m &= qp >= kp
    if window:
        m &= qp - kp < window
    s = jnp.where(m, s, -2e38)
    return np.asarray(jax.nn.logsumexp(s, axis=-1)).reshape(B, H, Sq)


@pytest.mark.parametrize("shape", FLASH + BLIND, ids=str)
def test_plain_lse_matches_the_reference(shape):
    causal, window = shape[7], shape[8]
    q, k, _ = _flash_inputs(shape)
    got = FA.flash_lse_plain(torch.from_numpy(q), torch.from_numpy(k),
                             causal=causal, window=window).numpy()
    want = _ref_lse(q, k, causal, window)
    assert got.shape == want.shape and got.dtype == np.float32
    seen = want > FA.NEG / 2
    np.testing.assert_allclose(got[seen], want[seen], rtol=LSE_TOL,
                               atol=LSE_TOL)
    # a row no key is visible to: NEG (log Sk absorbed), as the kernel
    # writes it
    assert (got[~seen] == np.float32(FA.NEG)).all()
    if shape in BLIND:
        assert (~seen).any()


@pytest.mark.parametrize("P, N, chunk, path", [
    (64, 64, 256, "tensor"),        # zamba2
    (16, 8, 64, "general"),         # N below the tensor path's widths
    (8, 4, 100, "general"),         # a chunk of no multiple of 16
    (32, 16, 128, "tensor"),
    (16, 64, 16, "tensor"),
    (48, 64, 256, "general"),       # P not a width of the tensor path
    (64, 64, 272, "general"),       # past the tensor path's longest chunk
    (64, 64, 100, "general"),       # a chunk of no multiple of 16
    (65, 64, 256, "general"),       # P past the tensor path's widths
    (64, 65, 256, "general"),       # and N
    (128, 128, 256, "general"),
    (64, 64, 2048, "general"),      # long chunks: cum in shared memory
    (64, 64, 4096, "general"),
    (128, 128, 6000, "general"),
    # the forward's general path's longest chunks at P = N = 128 and 64
    (128, 128, 12672, "general"),
    (64, 64, 37312, "general"),
])
def test_plan_backward(P, N, chunk, path):
    assert SSD.plan_backward(P, N, chunk) == path
    assert SSD.backward_smem(P, N, chunk) <= SSD.MAX_SMEM
    # x, B or C not 16-byte aligned: never the tensor path
    assert SSD.plan_backward(P, N, chunk, aligned=False) == "general"


def _forward_max_chunk(P, N):
    """The longest chunk the forward's general path takes at (P, N): its
    ``smem_bytes`` (``csrc/mamba2_ssd.cu``) within a block's 227 KB."""
    src = (CSRC / "mamba2_ssd.cu").read_text()
    body = re.search(r"size_t smem_bytes\(int P, int N, int chunk\) \{(.*?)\}",
                     src, re.S).group(1)
    assert re.sub(r"\s+", "", body) == (
        "returnsizeof(float)*((size_t)kT*(2*(N+1)+(P+1)+kT+1)+"
        "(size_t)P*(N+1)+(size_t)chunk);")
    return SSD.MAX_SMEM // 4 - (64 * (2 * (N + 1) + (P + 1) + 65) +
                                P * (N + 1))


@pytest.mark.parametrize("P", [1, 8, 33, 64, 65, 128])
def test_plan_backward_takes_every_chunk_the_forward_takes(P):
    for N in (1, 16, 64, 100, 128):
        assert SSD.plan_backward(P, N, _forward_max_chunk(P, N)) == \
            "general"


@pytest.mark.parametrize("P, N, chunk", [(129, 64, 256), (64, 200, 64),
                                         (128, 128, 40000)])
def test_plan_backward_refuses_what_no_path_takes(P, N, chunk):
    with pytest.raises(ValueError):
        SSD.plan_backward(P, N, chunk)


def _meta(*tensors):
    return [t.to("meta") for t in tensors]


@pytest.mark.parametrize("shape", [(2, 4, 2, 24, 40, 16, 16, False, 0),
                                   (2, 4, 4, 48, 48, 24, 16, True, 0)],
                         ids=str)
def test_flash_backward_fake_gives_the_plain_shapes(shape):
    B, H, Kh, Sq, Sk, D, Dv, causal, window = shape
    q, k, v = (torch.from_numpy(a) for a in _flash_inputs(shape))
    do = torch.ones((B, H, Sq, Dv))
    want = FA.flash_attention_backward(q, k, v, do, causal=causal,
                                       window=window)
    o, lse = FA.flash_attention_lse_op(*_meta(q, k, v), causal, window)
    assert tuple(o.shape) == (B, H, Sq, Dv) and \
        tuple(lse.shape) == (B, H, Sq) and lse.dtype == torch.float32
    got = FA.flash_attention_backward_op(*_meta(q, k, v, o, lse, do),
                                         causal, window)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert g.is_contiguous() and w.is_contiguous()


def test_ssd_backward_fake_gives_the_plain_shapes():
    g = torch.Generator().manual_seed(0)
    Bt, L, H, P, N, chunk = 2, 32, 3, 8, 4, 16
    x = torch.randn((Bt, L, H, P), generator=g)
    dt = torch.rand((Bt, L, H), generator=g) * 0.1
    A = -torch.rand((H,), generator=g)
    B, C = (torch.randn((Bt, L, N), generator=g) for _ in range(2))
    dy = torch.randn((Bt, L, H, P), generator=g)
    want = SSD.mamba2_ssd_backward(x, dt, A, B, C, dy, chunk=chunk)
    got = SSD.mamba2_ssd_backward_op(*_meta(x, dt, A, B, C, dy), chunk)
    for gt, w in zip(got, want):
        assert gt.shape == w.shape and gt.dtype == w.dtype


def test_dry_run_counts_one_backward_operator_a_call():
    """A differentiated call on meta tensors, as the dry run traces one:
    one forward and one backward operator each, no plain version."""
    gen = torch.Generator().manual_seed(1)

    def leaf(*shape):
        return torch.randn(shape, generator=gen).to("meta").requires_grad_()

    with trace.meta_operators(), OpCounter() as counter:
        q, k, v = leaf(2, 4, 64, 16), leaf(2, 2, 64, 16), leaf(2, 2, 64, 16)
        o = FA.flash_attention_cuda(q, k, v, causal=True)
        torch.autograd.grad(o, (q, k, v), torch.ones_like(o))
        x, dt, A = leaf(2, 64, 3, 8), leaf(2, 64, 3), leaf(3)
        B, C = leaf(2, 64, 4), leaf(2, 64, 4)
        y, _ = SSD.mamba2_ssd_cuda(x, dt, A, B, C, chunk=32)
        torch.autograd.grad(y, (x, dt, A, B, C), torch.ones_like(y))
    assert counter.result().kernel_calls == {
        "flash_attention": 1, "flash_attention_backward": 1,
        "mamba2_ssd": 1, "mamba2_ssd_backward": 1}


def test_meta_outside_the_dry_run_raises():
    q = torch.empty((1, 2, 8, 16), device="meta", requires_grad=True)
    with pytest.raises(ValueError):
        FA.flash_attention_cuda(q, q, q)


def _plain_kernel(q, k, v, o, lse, do, causal, window, scale=None,
                  path=None):
    """A stand-in for the backward kernels: autograd through the plain
    version at the (padded) shapes it is given, with the given scale (on
    any path)."""
    ins = [t.detach().requires_grad_() for t in (q, k, v)]
    with torch.enable_grad():
        out = FA._plain(*ins, causal, window, scale)
        return torch.autograd.grad(out, ins, do)


@pytest.mark.parametrize("shape", [(2, 4, 4, 48, 48, 24, 16, True, 0),
                                   (1, 2, 1, 40, 56, 40, 24, False, 0)],
                         ids=str)
def test_padded_head_dims_cut_the_gradients_back(shape, monkeypatch):
    B, H, Kh, Sq, Sk, D, Dv, causal, window = shape
    assert (D, Dv) not in FA.supported_head_dims()
    monkeypatch.setattr(FA, "_flash_backward_cuda", _plain_kernel)
    q, k, v = (torch.from_numpy(a) for a in _flash_inputs(shape))
    do = torch.from_numpy(np.random.default_rng(3).normal(
        size=(B, H, Sq, Dv)).astype(np.float32))
    o = FA.flash_attention_plain(q, k, v, causal=causal, window=window)
    got = FA._cuda_backward(q, k, v, o, None, do, causal, window)
    want = FA.flash_attention_backward(q, k, v, do, causal=causal,
                                       window=window)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.is_contiguous()
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)


def _c_params(src: str, name: str) -> list:
    m = re.search(r"\b" + name + r"\(([^)]*)\)\s*\{", src)
    assert m, name
    return [p.strip() for p in m.group(1).split(",") if p.strip()]


@pytest.mark.parametrize("source, signatures", [
    ("flash_attention.cu", FA._SIGNATURES),
    ("flash_attention.cu", FA._LSE_SIGNATURES),
    ("flash_attention_bwd.cu", FA._BWD_SIGNATURES),
    ("mamba2_ssd_bwd.cu", SSD._BWD_SIGNATURES)])
def test_c_interfaces_match_the_wrappers(source, signatures):
    """Each C function takes as many arguments, of the same kinds, as the
    ctypes signature its wrapper sets (a mismatch would only show on the
    card)."""
    src = (CSRC / source).read_text()
    kinds = {ctypes.c_int: "int", ctypes.c_float: "float"}
    for name, (args, _) in signatures.items():
        params = _c_params(src, name)
        assert len(params) == len(args), (name, params)
        for p, a in zip(params, args):
            want = "pointer" if "*" in p else p.split()[-2]
            assert kinds.get(a, "pointer") == want, (name, p, a)


def test_backward_smem_is_the_kernels():
    """``backward_smem`` mirrors ``chunk_smem_floats`` of the source at the
    general path's 32-row tiles; the tensor path's widths and longest chunk
    are the source's, whose static_assert fits its tiles within a block."""
    src = (CSRC / "mamba2_ssd_bwd.cu").read_text()
    body = re.search(r"chunk_smem_floats\([^)]*\)\s*\{(.*?)\n\}", src,
                     re.S).group(1)
    terms = re.sub(r"\(size_t\)|\s+", "", body)
    assert terms == ("return2*RT*(up4(P)+4)+2*RT*(up4(N)+4)+2*RT*(RT+4)+"
                     "16*RT+c+16;")
    assert "launch_nr<T, 32, 8>(a, p, st)" in src
    assert int(re.search(r"constexpr int kRowArrays = (\d+);", src)
               .group(1)) == SSD.ROW_ARRAYS
    assert SSD.backward_smem(64, 64, 256) == 4 * (
        2 * 32 * 68 * 2 + 2 * 32 * 36 + 16 * 32 + 256 + 16)
    assert int(re.search(r"constexpr int kTcMaxChunk = (\d+);", src)
               .group(1)) == SSD.TC_MAX_CHUNK
    dims = re.search(r"#define SSD_BWD_TC_DIMS\(X\)(.*)", src).group(1)
    assert tuple(int(d) for d in re.findall(r"X\((\d+)\)", dims)) == \
        SSD.TC_DIMS
    launch = re.search(r"int launch_tc\(.*?\n\}", src, re.S).group(0)
    fit = re.sub(r"\s+", "", re.search(r"static_assert\((.*?),\s*\"",
                                       launch, re.S).group(1))
    assert fit == ("states_tc_smem(P,N,kTcMaxChunk)<=(size_t)kMaxSmem&&"
                   "tc_smem_bytes(P,N,kTcMaxChunk)<=(size_t)kMaxSmem")
    assert f"constexpr int kMaxSmem = {SSD.MAX_SMEM};" in src


_FLASH_PATH_CASES = [
    (pair, dtype, "wgmma" if pair[0] == pair[1] and pair[0] in (64, 80, 128)
     else "general")
    for pair in [(16, 16), (32, 32), (48, 48), (64, 64), (80, 80), (96, 96),
                 (112, 112), (128, 128), (144, 144), (160, 160), (176, 176),
                 (192, 192), (208, 208), (224, 224), (240, 240), (256, 256),
                 (192, 128)]
    for dtype in (torch.float32, torch.bfloat16)]


@pytest.mark.parametrize("pair, dtype, path", _FLASH_PATH_CASES, ids=str)
def test_flash_plan_backward(pair, dtype, path):
    """Every pair the kernels take maps to its path in each dtype (the
    training head dims 64 and 80, and 128, to wgmma), and that path's
    launcher in the source holds its blocks' shared memory within 227 KB
    by a static_assert, so an instance that did not fit would not build."""
    assert pair in FA.supported_head_dims()
    assert FA.plan_backward(*pair, dtype) == path
    src = (CSRC / "flash_attention_bwd.cu").read_text()
    assert "constexpr int kMaxSmem = 232448;" in src
    name = "launch_wgmma" if path == "wgmma" else \
        "launch_f32" if dtype == torch.float32 else "launch_bf16"
    launcher = re.search(r"int " + name + r"\(const Ptrs& a.*?\n\}", src,
                         re.S).group(0)
    fits = re.findall(r"static_assert\(([^;]*?kMaxSmem[^;]*?),\s*\"",
                      launcher, re.S)
    assert fits, name


def test_flash_plan_backward_reads_the_source():
    """The wgmma path's head dims are the source's, and a pair the kernels
    do not take, or a dtype, raises."""
    assert FA.wgmma_head_dims() == (64, 80, 128)
    with pytest.raises(ValueError):
        FA.plan_backward(24, 16, torch.float32)
    with pytest.raises(ValueError):
        FA.plan_backward(64, 64, torch.float16)


def _split(x):
    """x (float64 holding fp32 values) as its bf16 hi and lo parts."""
    hi = x.float().bfloat16().double()
    lo = (x.float() - hi.float()).bfloat16().double()
    return hi, lo


def _split_mm(a, b):
    """a @ b as the kernels form it from split operands: hi.hi + hi.lo +
    lo.hi, each bf16 product exact, summed in float64 (the tensor cores'
    fp32 sums add rounding of their own, a far smaller term)."""
    ah, al = _split(a)
    bh, bl = _split(b)
    return ah @ bh + ah @ bl + al @ bh


def _rel64(got, want):
    return float((got - want).norm() / want.norm())


@pytest.mark.parametrize("D", [64, 80])
def test_split_products_meet_the_flash_bound(D):
    """The flash backward's five products at one 128 x 128 tile pair of
    fp32 inputs (S, dP, dV, dK, dQ), split as the wgmma path splits its
    operands and P and dS, against float64: each within a tenth of
    ``FLASH_BWD_REL`` (1e-4) for fp32."""
    rng = np.random.default_rng(D)
    Sq = Sk = 128
    q, k = (torch.from_numpy(rng.normal(size=(n, D)) * 0.3).float().double()
            for n in (Sq, Sk))
    v, do = (torch.from_numpy(rng.normal(size=(n, D))).float().double()
             for n in (Sk, Sq))
    scale = D ** -0.5
    s = q @ k.T * scale
    mask = torch.tril(torch.ones(Sq, Sk, dtype=torch.bool))
    s = s.masked_fill(~mask, -np.inf)
    p = torch.softmax(s, dim=-1)
    dp = do @ v.T
    delta = (p * dp).sum(-1, keepdim=True)
    ds = p * (dp - delta)
    want = {"S": q @ k.T, "dP": dp, "dV": p.T @ do, "dK": ds.T @ q,
            "dQ": ds @ k}
    got = {"S": _split_mm(q, k.T), "dP": _split_mm(do, v.T),
           "dV": _split_mm(p.T, do), "dK": _split_mm(ds.T, q),
           "dQ": _split_mm(ds, k)}
    for name in want:
        assert _rel64(got[name], want[name]) <= 1e-5, name
    # one bf16 rounding of each operand would miss the fp32 bound
    single = (q.float().bfloat16().double() @ k.T.float().bfloat16().double())
    assert _rel64(single, want["S"]) > 1e-4


def test_split_products_meet_the_ssd_bound():
    """One SSD chunk's G = C B^T, R = dy xdt^T and dxdt = (G o L)^T dy at
    zamba2's widths (c = 256, P = N = 64) from fp32 inputs, split as the
    tensor path splits its factors, against float64: each within a tenth
    of ``SSD_BWD_REL`` (1e-4) for fp32."""
    rng = np.random.default_rng(7)
    c, P, N = 256, 64, 64

    def f32(*shape, scale=1.0):
        return torch.from_numpy(rng.normal(size=shape) * scale).float() \
            .double()
    x, dy = f32(c, P), f32(c, P)
    B, C = f32(c, N, scale=0.3), f32(c, N, scale=0.3)
    dt = torch.from_numpy(np.log1p(np.exp(rng.normal(size=c))) * 0.1) \
        .float().double()
    cum = torch.cumsum(dt * -0.5, 0)
    L = torch.tril(torch.exp(cum[:, None] - cum[None, :]))
    xdt = (x * dt[:, None]).float().double()
    G, R = C @ B.T, dy @ xdt.T
    want = {"G": G, "R": R, "dxdt": (G * L).T @ dy}
    got = {"G": _split_mm(C, B.T), "R": _split_mm(dy, xdt.T),
           "dxdt": _split_mm((G * L).T.float().double(), dy)}
    for name in want:
        assert _rel64(got[name], want[name]) <= 1e-5, name
