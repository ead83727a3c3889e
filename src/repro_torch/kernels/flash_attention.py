"""Blocked online-softmax (flash) attention: the Hopper kernel and its plain
version.

The prefill attention of the LM stack.  ``flash_attention_cuda`` is the
port of the reference's ``flash_attention_pallas``.  On a CUDA tensor it
launches the hand-written kernel in ``csrc/flash_attention.cu`` (built with
``nvcc`` for ``sm_90a`` at first use into ``build/kernels/``, bound through
``ctypes``): in bf16 on the tensor cores (``wgmma``) fed by TMA loads, in
fp32 on the FMA units, exact.  On a CPU tensor it runs
``flash_attention_plain``, the same function in plain PyTorch.  Any other
device raises: there is no fallback from the kernel to the plain version.

Contract (the reference kernel's):

  * q (B, H, Sq, D), k (B, Kh, Sk, D), v (B, Kh, Sk, Dv), all fp32 or all
    bf16; query head h reads kv head h // (H // Kh); the output
    (B, H, Sq, Dv) has q's dtype;
  * scores are fp32 dots times D^-1/2; masked scores
    are ``NEG = -2e38``; the causal mask is left-aligned (query i sees keys
    j <= i whatever Sk - Sq is: ROADMAP R4), a window keeps i - j < window;
  * the softmax runs in fp32 and its probabilities are cast to v's dtype
    before the PV product.

The kernel takes strides, so (B, S, H, D) tensors of the model go in as
``transpose(1, 2)`` views without a copy (the feature dimension must be
contiguous, and base addresses and strides multiples of 16 bytes, for TMA
and ``cp.async``); the output is allocated (B, Sq, H, Dv) and returned as
its (B, H, Sq, Dv) view, so the model's transpose back is contiguous.  The
kernel takes the (D, Dv) pairs of ``supported_head_dims()``: every multiple
of 16 up to 256 with Dv = D, and 192 / 128.  ``flash_attention_cuda`` runs
any other pair up to 256 as the kernel's (P, P), P the larger of D and Dv
rounded up to 16: q, k and v are zero-padded to P, which adds nothing to
any score or output, the scale stays D^-1/2, and the output is cut back to
Dv (a smoke config's MLA, (24, 16), runs so).

Training differentiates through ``FlashAttention``: the kernel forward,
and as backward the gradient of the plain version in plain PyTorch
(``flash_attention_backward``), a sequence (or a block of queries) at a
time.

The kernel is the operator ``repro_torch::flash_attention``
(``torch.library.custom_op``, with a fake implementation and a flop
formula), so a mesh's ``local_map`` and the dry run's meta-tensor trace
see one operator, not the plain version.
"""
from __future__ import annotations

import ctypes
import functools
import re

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build, trace

NEG = -2.0e38

# launches of the CUDA kernel
launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_lib = None


def build(verbose: bool = False):
    """Compile ``csrc/flash_attention.cu`` into ``build/kernels/`` unless a
    library built from the same sources and flags is already there;
    returns its path."""
    return _build.build("flash_attention", verbose)


def _library():
    global _lib
    if _lib is None:
        lib = _build.library("flash_attention")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.fa_forward.argtypes = [ci, vp, vp, vp, vp, ci, ci, ci, ci, ci,
                                   ci, ci, ctypes.POINTER(ctypes.c_longlong),
                                   ctypes.c_float, ci, ci, vp]
        lib.fa_forward.restype = ci
        lib.fa_error_string.argtypes = [ci]
        lib.fa_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _masks(Sq: int, Sk: int, causal: bool, window: int, device,
           q_offset: int = 0):
    """(Sq, Sk) bool: which keys each query sees (left-aligned); the
    queries are positions ``q_offset`` on."""
    qpos = torch.arange(q_offset, q_offset + Sq, device=device)[:, None]
    kpos = torch.arange(Sk, device=device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        mask &= qpos >= kpos
    if window:
        mask &= qpos - kpos < window
    return mask


# the most bytes of fp32 scores the plain version holds at once
PLAIN_SCORE_BYTES = 1 << 32


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          scale=None):
    """The kernel's function in plain PyTorch, on whatever device the
    tensors are on: fp32 scores times ``scale`` (D^-1/2 by default),
    left-aligned masks to NEG, an fp32 softmax, probabilities cast to v's
    dtype before the PV product, the output in q's dtype.  The CPU path,
    and what the kernel is held against on the card.  It takes a few
    sequences at a time where the whole batch's scores would pass
    ``PLAIN_SCORE_BYTES``."""
    B, H, Sq, _ = q.shape
    n = max(1, PLAIN_SCORE_BYTES // (H * Sq * k.shape[2] * 4))
    if B > n:
        return torch.cat([_plain(q[b:b + n], k[b:b + n], v[b:b + n], causal,
                                 window, scale) for b in range(0, B, n)])
    return _plain(q, k, v, causal, window, scale)


def _plain(q, k, v, causal, window, scale, q_offset=0):
    """``flash_attention_plain`` of one piece, its queries at positions
    ``q_offset`` on."""
    B, H, Sq, D = q.shape
    Kh, Sk = k.shape[1], k.shape[2]
    qg = q.reshape(B, Kh, H // Kh, Sq, D)
    s = torch.einsum("bkgqd,bksd->bkgqs", qg.float(), k.float()).mul_(
        D ** -0.5 if scale is None else scale)
    s.masked_fill_(~_masks(Sq, Sk, causal, window, q.device, q_offset), NEG)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    o = torch.einsum("bkgqs,bksd->bkgqd", p.float(), v.float())
    return o.reshape(B, H, Sq, v.shape[-1]).to(q.dtype)


def flash_attention_backward(q, k, v, do, *, causal: bool = True,
                             window: int = 0):
    """(dq, dk, dv): the gradient of ``flash_attention_plain`` at (q, k, v)
    for the output gradient ``do``, by autograd through the plain version
    recomputed one piece at a time: a sequence, or a block of its queries
    where the sequence's (H, Sq, Sk) fp32 scores would pass
    ``PLAIN_SCORE_BYTES``.  So the backward never holds the whole batch's
    scores.  Plain PyTorch on every device."""
    B, H, Sq, _ = q.shape
    rows = max(1, PLAIN_SCORE_BYTES // (H * k.shape[2] * 4))
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    with torch.profiler.record_function("flash_attention.backward"):
        for b in range(B):
            kb = k[b:b + 1].detach().requires_grad_()
            vb = v[b:b + 1].detach().requires_grad_()
            gk = gv = 0.0           # summed over the query blocks in fp32
            for q0 in range(0, Sq, rows):
                qb = q[b:b + 1, :, q0:q0 + rows].detach().requires_grad_()
                with torch.enable_grad():
                    o = _plain(qb, kb, vb, causal, window, None, q0)
                    g = torch.autograd.grad(
                        o, (qb, kb, vb), do[b:b + 1, :, q0:q0 + rows])
                dq[b:b + 1, :, q0:q0 + rows] = g[0]
                gk, gv = gk + g[1].float(), gv + g[2].float()
            dk[b:b + 1], dv[b:b + 1] = gk, gv
    return dq, dk, dv


@functools.cache
def supported_head_dims() -> tuple:
    """The (D, Dv) pairs the CUDA kernel takes, in both dtypes: the list
    ``FA_HEAD_DIMS`` that ``csrc/flash_attention.cu`` instantiates, read
    from the source, so that there is one list.  The plain version (CPU)
    takes any."""
    src = (_build.CSRC / "flash_attention.cu").read_text()
    body = re.search(r"#define FA_HEAD_DIMS\(X\)((?:.*\\\n)*.*)", src)
    if body is None:
        raise RuntimeError("flash_attention.cu defines no FA_HEAD_DIMS")
    return tuple((int(d), int(dv))
                 for d, dv in re.findall(r"X\((\d+), (\d+)\)", body[1]))


def _tma_strides(t):
    """t's element strides over (b, h, s), 0 for a dimension of size 1
    (never stepped); raises unless the base address and every stride that
    is stepped are multiples of 16 bytes."""
    strides = [st if n > 1 else 0 for n, st in zip(t.shape[:3],
                                                   t.stride()[:3])]
    if t.data_ptr() % 16 or any(st * t.element_size() % 16
                                for st in strides):
        raise ValueError(f"flash_attention: the kernel needs 16-byte aligned "
                         f"rows (TMA, cp.async); got strides {t.stride()} "
                         f"of {t.dtype} at offset {t.data_ptr() % 16}")
    return strides


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k and v must be 4-D")
    B, H, Sq, D = q.shape
    if k.shape[0] != B or v.shape[:3] != k.shape[:3] or k.shape[3] != D:
        raise ValueError(f"flash_attention: bad shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    if H % k.shape[1] != 0:
        raise ValueError(f"flash_attention: {H} query heads over "
                         f"{k.shape[1]} kv heads")
    if min(Sq, k.shape[2], D, v.shape[3], B, H) < 1:
        raise ValueError("flash_attention: empty input")
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError("flash_attention: tensors on several devices")
    if len({q.dtype, k.dtype, v.dtype}) != 1:
        raise ValueError("flash_attention: q, k and v must share a dtype")


def padded_head_dims(D: int, Dv: int):
    """The (D, Dv) pair the kernel runs for a call at (D, Dv): the pair
    itself where it is instantiated, else (P, P) with P the larger of the
    two rounded up to 16 (``flash_attention_cuda`` zero-pads to it)."""
    if (D, Dv) in supported_head_dims():
        return D, Dv
    P = -(-max(D, Dv) // 16) * 16
    return P, P


def _flash_cuda(q, k, v, causal: bool, window: int, scale=None):
    global launches
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"flash_attention: no kernel for {q.dtype}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention: the feature dimension must be "
                         "contiguous")
    B, H, Sq, D = q.shape
    Kh, Sk, Dv = k.shape[1], k.shape[2], v.shape[3]
    if (D, Dv) not in supported_head_dims():
        raise ValueError(f"flash_attention: no kernel for head dims D={D}, "
                         f"Dv={Dv}: it takes (D, Dv) in "
                         f"{supported_head_dims()}")
    if B * H * -(-Sq // 64) >= 2 ** 31:
        raise ValueError(f"flash_attention: B={B} H={H} Sq={Sq} too large "
                         "for the grid")
    in_strides = [*_tma_strides(q), *_tma_strides(k), *_tma_strides(v)]
    lib = _library()
    o = torch.empty((B, Sq, H, Dv), dtype=q.dtype,
                    device=q.device).transpose(1, 2)
    strides = (ctypes.c_longlong * 12)(*in_strides, *o.stride()[:3])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.fa_forward(_DTYPE_CODE[q.dtype], q.data_ptr(),
                             k.data_ptr(), v.data_ptr(), o.data_ptr(), B, H,
                             Kh, Sq, Sk, D, Dv, strides,
                             D ** -0.5 if scale is None else scale,
                             int(causal), int(window), stream)
    if err != 0:
        raise RuntimeError("flash_attention: kernel launch failed: "
                           + lib.fa_error_string(err).decode())
    launches += 1
    return o


def _cuda_forward(q, k, v, causal, window):
    """The kernel on CUDA tensors, head dims it has no instance for padded
    as above."""
    D, Dv = q.shape[3], v.shape[3]
    P, Pv = padded_head_dims(D, Dv)
    if (P, Pv) == (D, Dv) or P > 256:
        return _flash_cuda(q, k, v, causal, window)
    o = _flash_cuda(F.pad(q, (0, P - D)), F.pad(k, (0, P - D)),
                    F.pad(v, (0, Pv - Dv)), causal, window, scale=D ** -0.5)
    return o[..., :Dv]


# The kernel as the operator ``repro_torch::flash_attention``: its real
# implementation launches the kernel on CUDA tensors (and raises on any
# other); its fake one gives the output's shape, so a trace on meta
# tensors (the mesh dry run) records the operator and never the plain
# version.  ``repro_torch::flash_attention_backward`` stands for the
# backward in such a trace: the gradient is autograd's through the plain
# version, which an operator's body cannot record (it runs below the
# autograd dispatch key), so on a device ``FlashAttention`` calls
# ``flash_attention_backward`` itself and the operator's body raises.
# The operators' namespace is ``repro_torch`` for the package's module; any
# other copy of the module (``kernel_compare.py`` loads another checkout's
# beside it) registers its own operators under its module name, so every
# copy launches through its own.
_NS = "repro_torch" if __name__ == "repro_torch.kernels.flash_attention" \
    else re.sub(r"\W", "_", __name__)


@torch.library.custom_op(f"{_NS}::flash_attention", mutates_args=())
def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       causal: bool, window: int) -> torch.Tensor:
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    return _cuda_forward(q, k, v, causal, window)


@flash_attention_op.register_fake
def _flash_fake(q, k, v, causal, window):
    B, H, Sq, _ = q.shape
    return q.new_empty((B, Sq, H, v.shape[3])).transpose(1, 2)


@torch.library.custom_op(f"{_NS}::flash_attention_backward",
                         mutates_args=())
def flash_attention_backward_op(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, do: torch.Tensor,
                                causal: bool, window: int
                                ) -> tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
    raise RuntimeError("flash_attention_backward: the operator is traced, "
                       "not run; call flash_attention_backward")


@flash_attention_backward_op.register_fake
def _flash_backward_fake(q, k, v, do, causal, window):
    return tuple(torch.empty_like(t, memory_format=torch.contiguous_format)
                 for t in (q, k, v))


def flash_flops(q_shape, k_shape, v_shape, causal, window) -> float:
    """Flops of one call: 2 (D + Dv) for each (query, key) pair the masks
    keep, a head.  The mesh dry run counts the operator by this."""
    B, H, Sq, D = q_shape
    Sk, Dv = k_shape[2], v_shape[3]
    return 2.0 * B * H * kept_pairs(Sq, Sk, causal, window) * (D + Dv)


def kept_pairs(Sq: int, Sk: int, causal: bool, window: int) -> int:
    """(query, key) pairs a head's masks keep (left-aligned): query i sees
    keys j <= i, and with a window i - j < window."""
    if not causal:
        return Sq * Sk
    W = window if 0 < window else Sk
    # query i keeps min(i + 1, W, Sk) keys
    n = 0
    top = min(Sq, Sk, W)          # rows below ``top`` keep i + 1
    n += top * (top + 1) // 2
    n += (Sq - top) * min(W, Sk)
    return n


def _register_flops():
    from torch.utils.flop_counter import flop_registry, register_flop_formula
    ops = getattr(torch.ops, _NS)
    if ops.flash_attention in flop_registry:
        return

    @register_flop_formula(ops.flash_attention)
    def _fwd(q, k, v, causal, window, *args, out_shape=None, **kw):
        return int(flash_flops(q, k, v, causal, window))

    @register_flop_formula(ops.flash_attention_backward)
    def _bwd(q, k, v, do, causal, window, *args, out_shape=None, **kw):
        # recompute the scores and P V, then dV, dP, dQ and dK
        return int(2.5 * flash_flops(q, k, v, causal, window))


_register_flops()


def _forward(q, k, v, causal, window):
    """The kernel's operator on a CUDA tensor (or a meta one inside
    ``trace.meta_operators()``, by its fake implementation), the plain
    version on a CPU tensor; any other device raises."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    if trace.operator_device(q.device):
        return flash_attention_op(q, k, v, causal, window)
    raise ValueError(f"flash_attention: no kernel for device {q.device}")


class FlashAttention(torch.autograd.Function):
    """Flash attention that autograd differentiates.  Forward: ``_forward``,
    the hand-written kernel on the card (launched again where a
    checkpointed block is recomputed).  Backward: the gradient of
    ``flash_attention_plain`` in plain PyTorch
    (``flash_attention_backward``).  The plain backward is the gradient
    the port defines, as the reference defines its own by autodiff of its
    jnp attention (it has no backward kernel); it is not a fallback, and a
    hand-written backward kernel is later work.  Its time on the card is
    in PERF.md."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        return _forward(q, k, v, causal, window)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        if q.device.type == "meta":
            g = flash_attention_backward_op(q, k, v, do, ctx.causal,
                                            ctx.window)
        else:
            g = flash_attention_backward(q, k, v, do, causal=ctx.causal,
                                         window=ctx.window)
        return (*g, None, None)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0
                         ) -> torch.Tensor:
    """q: (B, H, Sq, D); k/v: (B, Kh, Sk, D[v]).  Returns (B, H, Sq, Dv)
    in q's dtype: the kernel on a CUDA tensor, the plain version on a CPU
    tensor, through ``FlashAttention`` (which records nothing where grad
    is off or no input requires it, as in serving)."""
    _check(q, k, v)
    return FlashAttention.apply(q, k, v, causal, window)
