"""The backward kernels on the card, against their plain versions.

Marked ``cuda``: each test skips without a GPU (decided in the ``card``
fixture, never at import).  On a machine with a card and ``nvcc``:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_backward_cuda.py

builds the kernels at first use.  This file imports no JAX: on the card
the reference is the port's plain backward (autograd through the plain
version).  Bounds, relative Frobenius error of each gradient: fp32 1e-4
(fp32 products exact on the FMA units, or as split bf16 operands on the
tensor cores; other summation orders), bf16 2e-2 (flash: the kernels
round P and dS to bf16 operands, the plain version rounds dP; SSD: both
round their fp32 gradients to bf16 once); two calls on the same inputs
give the same bits (no float atomics).  Each backward runs on the path
its ``plan_backward`` gives; the SSD shapes cover both of its paths
("tensor" and "general"), and the flash backward also runs its general
path where the "wgmma" path is planned.
"""
import pytest
import torch

from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import mamba2_ssd as SSD

pytestmark = pytest.mark.cuda
REL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
DTYPES = (torch.float32, torch.bfloat16)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.Generator(device="cuda").manual_seed(0)


def _rel(got, want):
    got, want = got.float(), want.float()
    return float((got - want).norm() / want.norm().clamp(min=1e-30))


FLASH = [  # B, H, Kh, Sq, Sk, D, Dv, causal, window
    (2, 4, 2, 256, 256, 64, 64, True, 0),
    (2, 4, 2, 100, 300, 64, 64, False, 0),
    (1, 4, 2, 300, 128, 64, 64, True, 64),     # rows no key is visible to
    (1, 4, 2, 256, 256, 192, 128, True, 0),
    (1, 2, 2, 136, 136, 240, 240, True, 0),
    (1, 2, 1, 136, 136, 24, 16, True, 0),      # padded to (32, 32)
    (1, 4, 4, 200, 200, 80, 80, True, 0),      # the wgmma path's widths
    (1, 8, 1, 160, 160, 128, 128, True, 48),
]


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape", FLASH, ids=str)
def test_flash_backward_kernel_vs_plain(card, shape, dtype):
    B, H, Kh, Sq, Sk, D, Dv, causal, window = shape

    def rn(*s, scale=1.0):
        return (torch.randn(s, generator=card, device="cuda") * scale
                ).to(dtype).requires_grad_()
    q, k, v = rn(B, H, Sq, D, scale=0.3), rn(B, Kh, Sk, D, scale=0.3), \
        rn(B, Kh, Sk, Dv)
    do = torch.randn((B, H, Sq, Dv), generator=card, device="cuda").to(dtype)
    n = FA.backward_launches
    got = [torch.autograd.grad(FA.flash_attention_cuda(
        q, k, v, causal=causal, window=window), (q, k, v), do)
        for _ in range(2)]
    assert FA.backward_launches == n + 2
    assert FA.last_backward_plan == FA.plan_backward(
        *FA.padded_head_dims(D, Dv), dtype)
    want = FA.flash_attention_backward(q.detach(), k.detach(), v.detach(),
                                       do, causal=causal, window=window)
    for g, g2, w in zip(*got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, g2)
        assert _rel(g, w) <= REL[dtype]


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape", FLASH, ids=str)
def test_flash_backward_general_path_vs_plain(card, shape, dtype):
    """The general path, which every pair takes, also where the wgmma path
    is planned."""
    B, H, Kh, Sq, Sk, D, Dv, causal, window = shape

    def rn(*s, scale=1.0):
        return (torch.randn(s, generator=card, device="cuda") * scale
                ).to(dtype)
    q, k, v = rn(B, H, Sq, D, scale=0.3), rn(B, Kh, Sk, D, scale=0.3), \
        rn(B, Kh, Sk, Dv)
    do = rn(B, H, Sq, Dv)
    o, lse = FA.flash_attention_lse_op(q, k, v, causal, window)
    got = [FA._cuda_backward(q, k, v, o, lse, do, causal, window,
                             path="general") for _ in range(2)]
    assert FA.last_backward_plan == "general"
    want = FA.flash_attention_backward(q, k, v, do, causal=causal,
                                       window=window)
    for g, g2, w in zip(*got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, g2)
        assert _rel(g, w) <= REL[dtype]


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_flash_forward_lse_vs_plain(card, dtype):
    q = (torch.randn((1, 4, 300, 64), generator=card, device="cuda") * 0.3
         ).to(dtype)
    k = (torch.randn((1, 2, 128, 64), generator=card, device="cuda") * 0.3
         ).to(dtype)
    v = torch.randn((1, 2, 128, 64), generator=card, device="cuda").to(dtype)
    o, lse = FA.flash_attention_lse_op(q, k, v, True, 64)
    want = FA.flash_lse_plain(q, k, causal=True, window=64)
    torch.testing.assert_close(lse, want, rtol=1e-5, atol=1e-5)
    assert torch.equal(o, FA.flash_attention_op(q, k, v, True, 64))


SSD_SHAPES = [(2, 512, 4, 64, 64, 256), (2, 100, 3, 16, 16, 100),
              (1, 256, 2, 128, 96, 128), (2, 64, 3, 8, 4, 64),
              (1, 4096, 4, 64, 64, 4096),      # general: a long chunk
              (1, 256, 2, 32, 16, 128)]        # tensor: P != N


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape", SSD_SHAPES, ids=str)
def test_ssd_backward_kernel_vs_plain(card, shape, dtype):
    Bt, L, H, P, N, chunk = shape
    sp = torch.nn.functional.softplus

    def rn(*s, scale=1.0):
        return torch.randn(s, generator=card, device="cuda") * scale
    x = rn(Bt, L, H, P).to(dtype).requires_grad_()
    B = rn(Bt, L, N, scale=0.3).to(dtype).requires_grad_()
    C = rn(Bt, L, N, scale=0.3).to(dtype).requires_grad_()
    dt = (sp(rn(Bt, L, H)) * 0.1).requires_grad_()
    A = (-sp(rn(H))).requires_grad_()
    dy = rn(Bt, L, H, P)
    ins = (x, dt, A, B, C)
    n = SSD.backward_launches
    got = [torch.autograd.grad(SSD.mamba2_ssd_cuda(*ins, chunk=chunk)[0],
                               ins, dy) for _ in range(2)]
    assert SSD.backward_launches == n + 2
    assert SSD.last_backward_plan == SSD.plan_backward(P, N, chunk)
    want = SSD.mamba2_ssd_backward(*(t.detach() for t in ins), dy,
                                   chunk=chunk)
    for g, g2, w in zip(*got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, g2)
        assert _rel(g, w) <= REL[dtype]
