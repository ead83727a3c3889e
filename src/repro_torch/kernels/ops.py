"""Public wrappers for the kernels.

The port of the reference's ``kernels/ops.py``.  PyTorch runs eagerly, so
there is nothing to jit: each wrapper prepares its inputs and calls the
kernel wrapper in ``gallery_match``, ``ann_match``, ``flash_attention`` or
``mamba2_ssd``, which launches the CUDA kernel on a CUDA tensor and runs
the plain version on a CPU tensor.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ann_match import (cell_rescore_cuda,
                                           centroid_topc_cuda)
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.gallery_match import (gallery_match_cuda,
                                               gallery_match_quant_cuda,
                                               quantize_gallery)
from repro_torch.kernels.mamba2_ssd import mamba2_ssd_cuda


def _l2n(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=1e-9)


def gallery_match(q, g, *, k: int = 5):
    """Cosine top-k of queries (Q,D) against gallery (N,D): normalizes both
    sides, then runs the blocked matcher in fp32.  The reference runs this
    oracle path with a 512-row gallery block; blocking does not change the
    result, so the kernel keeps its own."""
    return gallery_match_cuda(_l2n(q.float()), _l2n(g.float()), k=k)


# -- identification fast path -------------------------------------------------
def gallery_match_fused(q, gn, *, k: int = 5):
    """Fast path vs a *pre-normalized* gallery (f32 or bf16 storage): the
    query L2 normalization is fused into the kernel."""
    return gallery_match_cuda(q, gn, k=k, fuse_norm=True)


def gallery_match_quant(q, g_q, g_scale, *, k: int = 5):
    """int8 fast path vs a pre-normalized, per-row-quantized gallery
    (``quantize_gallery``); fused query normalization, fp32 accumulation."""
    return gallery_match_quant_cuda(q, g_q, g_scale, k=k, fuse_norm=True)


def prepare_gallery_quant(gn: torch.Tensor):
    """Enrollment-time int8 preparation of a normalized gallery."""
    return quantize_gallery(gn)


# -- two-level ANN fast path --------------------------------------------------
def centroid_topc(q, centroids, *, c: int):
    """Coarse probe selection: raw queries vs the (K, D) codebook (f32 or
    bf16 storage), fused query normalization; returns top-``c`` cell ids."""
    return centroid_topc_cuda(q, centroids, c=c, fuse_norm=True)


def centroid_topc_quant(q, c_q, c_scale, *, c: int):
    """int8-codebook coarse scan (per-row quantized centroids)."""
    return centroid_topc_cuda(q, c_q, c_scale, c=c, fuse_norm=True)


def cell_rescore(q, cells, cell_ids, cell_lens, *, k: int, L: int):
    """Exact rescore of each query against its probed cells only (f32 or
    bf16 packed cell-major storage); returns padded positions."""
    return cell_rescore_cuda(q, cells, cell_ids, cell_lens, k=k, L=L,
                             fuse_norm=True)


def cell_rescore_quant(q, cells_q, cell_scale, cell_ids, cell_lens, *,
                       k: int, L: int):
    """int8 packed-cell rescore (per-row quantized, fp32 accumulation)."""
    return cell_rescore_cuda(q, cells_q, cell_ids, cell_lens, cell_scale,
                             k=k, L=L, fuse_norm=True)


# -- LM stack ----------------------------------------------------------------
def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B,H,S,D); k/v: (B,Kh,S,Dv)."""
    return flash_attention_cuda(q, k, v, causal=causal, window=window)


def mamba2_ssd(x, dt, A, B, C):
    """Chunk-parallel SSD scan (chunk ``min(256, L)``); see mamba2_ssd.py."""
    return mamba2_ssd_cuda(x, dt, A, B, C)
