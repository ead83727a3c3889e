"""Blocked cosine top-k gallery matching: the Hopper kernel and its plain
version.

The Database cartridge's hot path: score Q protected query templates
against an N-row protected gallery and keep the top-k matches per query.
``gallery_match_cuda`` / ``gallery_match_quant_cuda`` are the port of the
reference's ``gallery_match_pallas`` / ``gallery_match_quant_pallas``.  On a
CUDA tensor they launch the hand-written kernel in
``csrc/gallery_match.cu`` (built with ``nvcc`` for ``sm_90a`` at first use
into ``build/kernels/``, bound through ``ctypes``); on a CPU tensor they run
``gallery_match_plain``, the same function in plain PyTorch.  Any other
device raises: there is no fallback from the kernel to the plain version.

Contract (the reference kernel's):

  * fp32 dots with fp32 accumulation for every storage dtype — fp32, bf16
    (the query is cast to bf16 first, as the gallery) and int8 (per-row
    symmetric quantization; the row's scale multiplies the score after the
    dot, the query stays fp32);
  * ``fuse_norm=True`` L2-normalizes the query in the kernel as
    ``q * rsqrt(max(sum(q^2), 1e-18))``; the gallery comes pre-normalized;
  * top-k ordered by score descending, then gallery index ascending (ties
    go to the lowest index);
  * ``k > N`` is clamped to N and the trailing columns hold the sentinels
    (``NEG``, -1).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

NEG = -3.0e38
MAX_K = 64              # the kernel keeps two list entries per lane
MAX_D = 512             # query tile + gallery tile fit the 227 KB of smem

# launches of the CUDA kernel (both passes count as one)
launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_lib = None


def build(verbose: bool = False):
    """Compile ``csrc/gallery_match.cu`` into ``build/kernels/`` unless a
    library built from the same sources and flags is already there;
    returns its path."""
    return _build.build("gallery_match", verbose)


def _library():
    global _lib
    if _lib is None:
        lib = _build.library("gallery_match")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.gm_match.argtypes = [ci, vp, vp, vp, ci, ci, ci, ci, ci, ci,
                                 vp, vp, vp, vp, vp]
        lib.gm_match.restype = ci
        lib.gm_error_string.argtypes = [ci]
        lib.gm_error_string.restype = ctypes.c_char_p
        lib.gm_max_k.argtypes = []
        lib.gm_max_k.restype = ci
        assert lib.gm_max_k() == MAX_K
        _lib = lib
    return _lib


def _splits(dev, n_qtiles: int, N: int) -> int:
    """Gallery splits per query tile: enough blocks for a few waves over
    the card's SMs, each split at least one 64-row tile."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return max(1, min(-(-N // 64), -(-4 * sms // n_qtiles)))


def _match_cuda(q, g, g_scale, k_eff: int, fuse_norm: bool):
    global launches
    Q, D = q.shape
    N = g.shape[0]
    if g.dtype not in _DTYPE_CODE:
        raise ValueError(f"gallery_match: no kernel for a {g.dtype} gallery")
    want_q = torch.bfloat16 if g.dtype == torch.bfloat16 else torch.float32
    if q.dtype != want_q or (g_scale is not None
                             and g_scale.dtype != torch.float32):
        raise ValueError(f"gallery_match: a {g.dtype} gallery takes {want_q} "
                         "queries and fp32 scales")
    if not (q.is_contiguous() and g.is_contiguous()):
        raise ValueError("gallery_match: q and g must be contiguous")
    if g_scale is not None and not g_scale.is_contiguous():
        raise ValueError("gallery_match: g_scale must be contiguous")
    if D > MAX_D:
        raise ValueError(f"gallery_match: D={D} above the kernel's {MAX_D}")
    if k_eff > MAX_K:
        raise ValueError(f"gallery_match: k={k_eff} above the kernel's "
                         f"{MAX_K}")
    lib = _library()
    dev = q.device
    S = _splits(dev, -(-Q // 32), N)
    part_s = torch.empty((Q, S, k_eff), dtype=torch.float32, device=dev)
    part_i = torch.empty((Q, S, k_eff), dtype=torch.int32, device=dev)
    out_s = torch.empty((Q, k_eff), dtype=torch.float32, device=dev)
    out_i = torch.empty((Q, k_eff), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.gm_match(
            _DTYPE_CODE[g.dtype], q.data_ptr(), g.data_ptr(),
            g_scale.data_ptr() if g_scale is not None else None,
            Q, N, D, k_eff, int(fuse_norm), S, part_s.data_ptr(),
            part_i.data_ptr(), out_s.data_ptr(), out_i.data_ptr(), stream)
    if err != 0:
        raise RuntimeError("gallery_match: kernel launch failed: "
                           + lib.gm_error_string(err).decode())
    launches += 1
    return out_s, out_i


def _topk_sorted(s: torch.Tensor, k_eff: int):
    """Top-k of each row by score descending, index ascending on ties (a
    stable sort; ``torch.topk`` promises no order among ties)."""
    scores, idx = torch.sort(s, dim=1, descending=True, stable=True)
    return scores[:, :k_eff].contiguous(), \
        idx[:, :k_eff].to(torch.int32).contiguous()


def gallery_match_plain(q, g, g_scale=None, *, k: int, fuse_norm: bool):
    """The kernel's function in plain PyTorch, on whatever device the
    tensors are on (``k`` already clamped to N): the CPU path, and what the
    kernel is held against on the card."""
    qf = q.float()
    if fuse_norm:
        qf = qf * torch.rsqrt(torch.clamp(
            (qf * qf).sum(dim=-1, keepdim=True), min=1e-18))
    s = qf @ g.float().T
    if g_scale is not None:
        s = s * g_scale.float()[None, :]
    return _topk_sorted(s, k)


def _check(q, g, g_scale):
    if q.dim() != 2 or g.dim() != 2 or q.shape[1] != g.shape[1]:
        raise ValueError(f"gallery_match: bad shapes q{tuple(q.shape)} "
                         f"g{tuple(g.shape)}")
    if g.shape[0] == 0:
        raise ValueError("gallery_match: empty gallery")
    if q.shape[0] == 0:
        raise ValueError("gallery_match: no queries")
    devs = {q.device, g.device} | ({g_scale.device} if g_scale is not None
                                   else set())
    if len(devs) != 1:
        raise ValueError(f"gallery_match: tensors on several devices {devs}")
    if g_scale is not None and tuple(g_scale.shape) != (g.shape[0],):
        raise ValueError("gallery_match: g_scale must be (N,)")


def _launch(q, g, g_scale, *, k: int, fuse_norm: bool):
    _check(q, g, g_scale)
    N = g.shape[0]
    k_eff = max(1, min(k, N))                          # clamp k > N
    if q.device.type == "cpu":
        scores, idx = gallery_match_plain(q, g, g_scale, k=k_eff,
                                          fuse_norm=fuse_norm)
    elif q.device.type == "cuda":
        scores, idx = _match_cuda(q, g, g_scale, k_eff, fuse_norm)
    else:
        raise ValueError(f"gallery_match: no kernel for device {q.device}")
    if k_eff < k:                                      # k > N sentinels
        Q = q.shape[0]
        scores = torch.cat([scores, scores.new_full((Q, k - k_eff), NEG)], 1)
        idx = torch.cat([idx, idx.new_full((Q, k - k_eff), -1)], 1)
    return scores, idx


def gallery_match_cuda(q: torch.Tensor, g: torch.Tensor, *, k: int = 5,
                       fuse_norm: bool = False):
    """q: (Q, D) queries; g: (N, D) gallery rows, fp32 or bf16 (both
    normalized unless ``fuse_norm`` handles the queries in the kernel).
    Returns (scores (Q, k) f32, idx (Q, k) i32), scores descending; when
    ``k > N`` the trailing columns hold (NEG, -1)."""
    if g.dtype == torch.bfloat16:
        q = q.to(torch.bfloat16)
    else:
        q = q.float()
        g = g.float()
    return _launch(q.contiguous(), g, None, k=k, fuse_norm=fuse_norm)


def gallery_match_quant_cuda(q: torch.Tensor, g_q: torch.Tensor,
                             g_scale: torch.Tensor, *, k: int = 5,
                             fuse_norm: bool = False):
    """int8 path: ``g_q`` (N, D) int8 per-row quantized gallery with fp32
    ``g_scale`` (N,); the query stays fp32, scores are fp32-accumulated then
    scaled per gallery row."""
    if g_q.dtype != torch.int8:
        raise ValueError(f"gallery_match_quant: g_q must be int8, not "
                         f"{g_q.dtype}")
    return _launch(q.float().contiguous(), g_q, g_scale.float(), k=k,
                   fuse_norm=fuse_norm)


def quantize_gallery(g: torch.Tensor):
    """Symmetric per-row int8 quantization: returns (values (N, D) int8,
    scale (N,) f32) with ``values * scale[:, None] ~= g``.  ``torch.round``
    rounds half to even, as the reference does."""
    g = g.float()
    amax = g.abs().amax(dim=-1)
    scale = torch.clamp(amax / 127.0, min=1e-12)
    q = torch.clamp(torch.round(g / scale[:, None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_gallery(g_q: torch.Tensor, g_scale: torch.Tensor):
    """Inverse of ``quantize_gallery`` (the int8 oracle's input)."""
    return g_q.float() * g_scale.float()[:, None]
