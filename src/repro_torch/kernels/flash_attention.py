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

Training differentiates through ``FlashAttention``.  On the card its
forward is the kernel's instance that also writes each row's log-sum-exp
(``repro_torch::flash_attention_lse``, built from
``csrc/flash_attention_lse.cu``), and its backward the hand-written
backward kernels in ``csrc/flash_attention_bwd.cu`` (FlashAttention-2:
dK and dV a key tile a block, dQ a query tile a block, no float atomics;
``repro_torch::flash_attention_backward``).  On the CPU the backward is
the gradient of the plain version in plain PyTorch
(``flash_attention_backward``, a sequence or a block of queries at a
time), which the kernels are held against on the card.

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

# launches of the CUDA forward kernel, and of the backward kernels (one a
# backward call: its three kernels, seven on the fp32 wgmma path)
launches = 0
backward_launches = 0
# the path ("wgmma" or "general") of the last backward call on the card
last_backward_plan = None

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_lib = None
_lse_lib = None
_bwd_lib = None


def build(verbose: bool = False):
    """Compile ``csrc/flash_attention.cu`` into ``build/kernels/`` unless a
    library built from the same sources and flags is already there;
    returns its path."""
    return _build.build("flash_attention", verbose)


def build_lse(verbose: bool = False):
    """``build`` of the training forward, ``csrc/flash_attention_lse.cu``:
    the forward's instances that also write each row's log-sum-exp, a
    library of their own so that nvcc builds the two halves in parallel."""
    return _build.build("flash_attention_lse", verbose)


def build_backward(verbose: bool = False):
    """``build`` of the backward kernels, ``csrc/flash_attention_bwd.cu``."""
    return _build.build("flash_attention_bwd", verbose)


_ci, _vp, _cf = ctypes.c_int, ctypes.c_void_p, ctypes.c_float
_strides = ctypes.POINTER(ctypes.c_longlong)
# the C functions of the libraries built from csrc/flash_attention.cu,
# csrc/flash_attention_lse.cu and csrc/flash_attention_bwd.cu: (argument
# types, result type)
_SIGNATURES = {
    "fa_forward": ([_ci, _vp, _vp, _vp, _vp, _ci, _ci, _ci, _ci, _ci, _ci,
                    _ci, _strides, _cf, _ci, _ci, _vp], _ci),
    "fa_error_string": ([_ci], ctypes.c_char_p),
}
_LSE_SIGNATURES = {
    "fa_forward_lse": ([_ci, _vp, _vp, _vp, _vp, _vp, _ci, _ci, _ci, _ci,
                        _ci, _ci, _ci, _strides, _cf, _ci, _ci, _vp], _ci),
    "fa_error_string": ([_ci], ctypes.c_char_p),
}
_BWD_SIGNATURES = {
    "fa_backward": ([_ci, _ci, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp,
                     _vp, _vp, _ci, _ci, _ci, _ci, _ci, _ci, _ci, _strides,
                     _cf, _ci, _ci, _cf, _vp], _ci),
    "fa_backward_error_string": ([_ci], ctypes.c_char_p),
}


def _bind(name, signatures):
    lib = _build.library(name)
    for fn, (args, res) in signatures.items():
        getattr(lib, fn).argtypes, getattr(lib, fn).restype = args, res
    return lib


def _library():
    global _lib
    if _lib is None:
        _lib = _bind("flash_attention", _SIGNATURES)
    return _lib


def _lse_library():
    global _lse_lib
    if _lse_lib is None:
        _lse_lib = _bind("flash_attention_lse", _LSE_SIGNATURES)
    return _lse_lib


def _backward_library():
    global _bwd_lib
    if _bwd_lib is None:
        _bwd_lib = _bind("flash_attention_bwd", _BWD_SIGNATURES)
    return _bwd_lib


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


def flash_lse_plain(q, k, *, causal: bool = True, window: int = 0,
                    scale=None):
    """(B, H, Sq) fp32: each query row's natural log-sum-exp of its masked
    fp32 scores, as ``flash_attention_plain`` forms them (a row that no key
    is visible to gives NEG: log Sk is absorbed).  What the forward's
    ``lse`` output is held against."""
    B, H, Sq, D = q.shape
    Kh, Sk = k.shape[1], k.shape[2]
    s = torch.einsum("bkgqd,bksd->bkgqs", q.reshape(B, Kh, H // Kh, Sq,
                                                     D).float(),
                     k.float()).mul_(D ** -0.5 if scale is None else scale)
    s.masked_fill_(~_masks(Sq, Sk, causal, window, q.device), NEG)
    return torch.logsumexp(s, dim=-1).reshape(B, H, Sq)


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
    """The (D, Dv) pairs the CUDA kernels take, forward and backward, in
    both dtypes: the list ``FA_HEAD_DIMS`` that ``csrc/flash_head_dims.cuh``
    holds for both sources, read from there, so that there is one list.
    The plain version (CPU) takes any."""
    src = (_build.CSRC / "flash_head_dims.cuh").read_text()
    body = re.search(r"#define FA_HEAD_DIMS\(X\)((?:.*\\\n)*.*)", src)
    if body is None:
        raise RuntimeError("flash_head_dims.cuh defines no FA_HEAD_DIMS")
    return tuple((int(d), int(dv))
                 for d, dv in re.findall(r"X\((\d+), (\d+)\)", body[1]))


# the backward's paths (``plan_backward``): "wgmma" (TMA and warpgroup
# products; fp32 through split bf16 operands) for D = Dv in
# ``wgmma_head_dims()``, "general" (mma.sync in bf16, FMAs in fp32) for
# every other pair of ``supported_head_dims()``
BACKWARD_PATHS = ("wgmma", "general")


@functools.cache
def wgmma_head_dims() -> tuple:
    """The D = Dv of the backward's wgmma path: ``FA_BWD_WGMMA_DIMS`` in
    ``csrc/flash_attention_bwd.cu``, read from there."""
    src = (_build.CSRC / "flash_attention_bwd.cu").read_text()
    body = re.search(r"#define FA_BWD_WGMMA_DIMS\(X\)(.*)", src)
    if body is None:
        raise RuntimeError("flash_attention_bwd.cu defines no "
                           "FA_BWD_WGMMA_DIMS")
    return tuple(int(d) for d in re.findall(r"X\((\d+)\)", body[1]))


def plan_backward(D: int, Dv: int, dtype) -> str:
    """The path a backward call at head dims (D, Dv) (a pair of
    ``supported_head_dims()``, as the kernels run it) in ``dtype`` takes:
    ``"wgmma"`` for D = Dv in ``wgmma_head_dims()``, else ``"general"``;
    raises for a pair no path takes.  Every instance of either path fits a
    block's shared memory: the source's static_asserts hold it to 227 KB."""
    if (D, Dv) not in supported_head_dims():
        raise ValueError(f"flash_attention_backward: no kernel for head dims "
                         f"D={D}, Dv={Dv}")
    if dtype not in _DTYPE_CODE:
        raise ValueError(f"flash_attention_backward: no kernel for {dtype}")
    if D == Dv and D in wgmma_head_dims():
        return "wgmma"
    return "general"


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


def _flash_cuda(q, k, v, causal: bool, window: int, scale=None,
                lse: bool = False):
    """The forward kernel; with ``lse`` the instance that also writes each
    row's log-sum-exp (the training forward's library), returned beside
    the output."""
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
    lib = _lse_library() if lse else _library()
    o = torch.empty((B, Sq, H, Dv), dtype=q.dtype,
                    device=q.device).transpose(1, 2)
    strides = (ctypes.c_longlong * 12)(*in_strides, *o.stride()[:3])
    rest = (B, H, Kh, Sq, Sk, D, Dv, strides,
            D ** -0.5 if scale is None else scale, int(causal), int(window))
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr())
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if lse:
            m = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
            err = lib.fa_forward_lse(_DTYPE_CODE[q.dtype], *ptrs,
                                     m.data_ptr(), *rest, stream)
        else:
            err = lib.fa_forward(_DTYPE_CODE[q.dtype], *ptrs, *rest, stream)
    if err != 0:
        raise RuntimeError("flash_attention: kernel launch failed: "
                           + lib.fa_error_string(err).decode())
    launches += 1
    return (o, m) if lse else o


def _cuda_forward(q, k, v, causal, window, lse: bool = False):
    """The kernel on CUDA tensors, head dims it has no instance for padded
    as above; with ``lse``, (output, lse)."""
    D, Dv = q.shape[3], v.shape[3]
    P, Pv = padded_head_dims(D, Dv)
    if (P, Pv) == (D, Dv) or P > 256:
        return _flash_cuda(q, k, v, causal, window, lse=lse)
    out = _flash_cuda(F.pad(q, (0, P - D)), F.pad(k, (0, P - D)),
                      F.pad(v, (0, Pv - Dv)), causal, window,
                      scale=D ** -0.5, lse=lse)
    return (out[0][..., :Dv], out[1]) if lse else out[..., :Dv]


def _aligned(t):
    """``t`` itself where its rows are 16-byte aligned with a contiguous
    feature dimension, else a contiguous copy."""
    ok = t.stride(-1) == 1 and t.data_ptr() % 16 == 0 and all(
        st * t.element_size() % 16 == 0 for n, st in zip(t.shape[:3],
                                                         t.stride()[:3])
        if n > 1)
    return t if ok else t.contiguous()


def _flash_backward_cuda(q, k, v, o, lse, do, causal, window, scale=None,
                         path=None):
    """(dq, dk, dv), contiguous, from the backward kernels on the path
    ``plan_backward`` gives.  ``path="general"`` is for the card's checks
    only: it holds the general path against the plain backward at pairs the
    wgmma path takes too; training never passes it."""
    global backward_launches, last_backward_plan
    if q.dtype not in _DTYPE_CODE or len({q.dtype, k.dtype, v.dtype, o.dtype,
                                          do.dtype}) != 1:
        raise ValueError(f"flash_attention_backward: no kernel for "
                         f"{q.dtype}, {do.dtype}")
    B, H, Sq, D = q.shape
    Kh, Sk, Dv = k.shape[1], k.shape[2], v.shape[3]
    planned = plan_backward(D, Dv, q.dtype)
    path = path or planned
    if path not in (planned, "general"):
        raise ValueError(f"flash_attention_backward: no {path} path for "
                         f"D={D}, Dv={Dv} in {q.dtype}")
    if tuple(lse.shape) != (B, H, Sq) or lse.dtype != torch.float32 or \
            not lse.is_contiguous():
        raise ValueError("flash_attention_backward: lse must be a contiguous "
                         f"fp32 {(B, H, Sq)}")
    if o.stride(-1) != 1:
        o = o.contiguous()
    do = _aligned(do)
    for t in (q, k, v):
        _tma_strides(t)
        if t.stride(-1) != 1:
            raise ValueError("flash_attention_backward: the feature "
                             "dimension must be contiguous")
    dq, dk, dv = (torch.empty(t.shape, dtype=t.dtype, device=t.device)
                  for t in (q, k, v))
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    # the fp32 wgmma path's bf16 hi and lo planes of q, k, v and dO
    split = torch.empty(
        (2 * sum(t.numel() for t in (q, k, v, do))
         if path == "wgmma" and q.dtype == torch.float32 else 1,),
        dtype=torch.bfloat16, device=q.device)
    tensors = (q, k, v, o, do, dq, dk, dv)
    strides = (ctypes.c_longlong * 24)(*(st if n > 1 else 0 for t in tensors
                                         for n, st in zip(t.shape[:3],
                                                          t.stride()[:3])))
    # the plain softmax's weight of a row that no key is visible to, as it
    # casts its probabilities to v's dtype
    pinv = float(torch.tensor(1.0 / Sk, dtype=torch.float32).to(v.dtype))
    lib = _backward_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.fa_backward(_DTYPE_CODE[q.dtype], BACKWARD_PATHS.index(path),
                              *(t.data_ptr() for t in tensors[:5]),
                              lse.data_ptr(), delta.data_ptr(),
                              split.data_ptr(),
                              *(t.data_ptr() for t in tensors[5:]), B, H, Kh,
                              Sq, Sk, D, Dv, strides,
                              D ** -0.5 if scale is None else scale,
                              int(causal), int(window), pinv, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_backward: {path} kernel launch "
                           "failed: "
                           + lib.fa_backward_error_string(err).decode())
    backward_launches += 1
    last_backward_plan = path
    return dq, dk, dv


def _cuda_backward(q, k, v, o, lse, do, causal, window, path=None):
    """The backward kernels on CUDA tensors (on ``path``, as
    ``_flash_backward_cuda``), head dims they have no instance for padded
    as the forward pads them (zero columns add nothing to any score, output
    or gradient) and the gradients cut back."""
    D, Dv = q.shape[3], v.shape[3]
    P, Pv = padded_head_dims(D, Dv)
    if (P, Pv) == (D, Dv) or P > 256:
        return _flash_backward_cuda(q, k, v, o, lse, do, causal, window,
                                    path=path)
    g = _flash_backward_cuda(F.pad(q, (0, P - D)), F.pad(k, (0, P - D)),
                             F.pad(v, (0, Pv - Dv)), F.pad(o, (0, Pv - Dv)),
                             lse, F.pad(do, (0, Pv - Dv)), causal, window,
                             scale=D ** -0.5, path=path)
    return tuple(t[..., :n].contiguous() for t, n in zip(g, (D, D, Dv)))


# The kernels as operators: ``repro_torch::flash_attention`` (serving's
# forward), ``repro_torch::flash_attention_lse`` (training's forward, which
# also gives the log-sum-exp) and ``repro_torch::flash_attention_backward``
# (the backward kernels).  Their real implementations launch the kernels
# on CUDA tensors (and raise on any other); their fake ones give the
# outputs' shapes, so a trace on meta tensors (the mesh dry run) records
# the operators and never the plain version.  The operators' namespace is
# ``repro_torch`` for the package's module; any other copy of the module
# (``kernel_compare.py`` loads another checkout's beside it) registers its
# own operators under its module name, so every copy launches through its
# own.
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


@torch.library.custom_op(f"{_NS}::flash_attention_lse", mutates_args=())
def flash_attention_lse_op(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, causal: bool, window: int
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    return _cuda_forward(q, k, v, causal, window, lse=True)


@flash_attention_lse_op.register_fake
def _flash_lse_fake(q, k, v, causal, window):
    B, H, Sq, _ = q.shape
    return (_flash_fake(q, k, v, causal, window),
            q.new_empty((B, H, Sq), dtype=torch.float32))


@torch.library.custom_op(f"{_NS}::flash_attention_backward",
                         mutates_args=())
def flash_attention_backward_op(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, o: torch.Tensor,
                                lse: torch.Tensor, do: torch.Tensor,
                                causal: bool, window: int
                                ) -> tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_backward: no kernel for device "
                         f"{q.device}")
    _check(q, k, v)
    return _cuda_backward(q, k, v, o, lse, do, causal, window)


@flash_attention_backward_op.register_fake
def _flash_backward_fake(q, k, v, o, lse, do, causal, window):
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

    @register_flop_formula(ops.flash_attention_lse)
    def _fwd_lse(q, k, v, causal, window, *args, out_shape=None, **kw):
        return int(flash_flops(q, k, v, causal, window))

    @register_flop_formula(ops.flash_attention_backward)
    def _bwd(q, k, v, o, lse, do, causal, window, *args, out_shape=None,
             **kw):
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


def _forward_lse(q, k, v, causal, window):
    """(output, lse) for a graph that will be differentiated: on a CUDA
    tensor the kernel's operator that writes lse; on a meta one inside
    ``trace.meta_operators()`` serving's operator (the dry run counts one
    forward operator a call) and an lse of the right shape; on a CPU tensor
    the plain version, whose backward needs no lse (None)."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal,
                                     window=window), None
    if q.device.type == "cuda":
        return flash_attention_lse_op(q, k, v, causal, window)
    o = _forward(q, k, v, causal, window)
    B, H, Sq, _ = q.shape
    return o, q.new_empty((B, H, Sq), dtype=torch.float32)


class FlashAttention(torch.autograd.Function):
    """Flash attention that autograd differentiates.  ``record``: a graph
    will be differentiated (grad on and an input requires it); else the
    forward is serving's and saves nothing.  Forward: the hand-written
    kernel on the card (launched again where a checkpointed block is
    recomputed), when recording its instance that also writes each row's
    log-sum-exp.  Backward: on the card the backward kernels
    (``flash_attention_backward_op``); on the CPU the gradient of
    ``flash_attention_plain`` in plain PyTorch
    (``flash_attention_backward``), the gradient the port defines, as the
    reference defines its own by autodiff of its jnp attention, and what
    the kernels are held against on the card."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, record):
        ctx.causal, ctx.window = causal, window
        if not record:
            return _forward(q, k, v, causal, window)
        o, lse = _forward_lse(q, k, v, causal, window)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if q.device.type == "cpu":
            g = flash_attention_backward(q, k, v, do, causal=ctx.causal,
                                         window=ctx.window)
        elif trace.operator_device(q.device):
            with torch.profiler.record_function("flash_attention.backward"):
                g = flash_attention_backward_op(q, k, v, o, lse, do,
                                                ctx.causal, ctx.window)
        else:
            raise ValueError(f"flash_attention: no kernel for device "
                             f"{q.device}")
        return (*g, None, None, None)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0
                         ) -> torch.Tensor:
    """q: (B, H, Sq, D); k/v: (B, Kh, Sk, D[v]).  Returns (B, H, Sq, Dv)
    in q's dtype: the kernel on a CUDA tensor, the plain version on a CPU
    tensor, through ``FlashAttention`` (which records nothing where grad
    is off or no input requires it, as in serving)."""
    _check(q, k, v)
    record = torch.is_grad_enabled() and any(t.requires_grad
                                             for t in (q, k, v))
    return FlashAttention.apply(q, k, v, causal, window, record)
