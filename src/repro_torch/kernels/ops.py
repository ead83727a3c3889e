"""Public wrappers for the match kernels.

The port of the reference's ``kernels/ops.py`` match wrappers.  PyTorch runs
eagerly, so there is nothing to jit: each wrapper prepares its inputs and
calls the kernel wrapper in ``gallery_match``, which launches the CUDA
kernel on a CUDA tensor and runs the plain version on a CPU tensor.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.gallery_match import (gallery_match_cuda,
                                               gallery_match_quant_cuda,
                                               quantize_gallery)


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
