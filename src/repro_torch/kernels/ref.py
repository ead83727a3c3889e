"""Plain PyTorch oracles for the match kernels (the correctness contract).

Ports of the reference's ``kernels/ref.py`` match oracles.  The ANN and LM
oracles port with their slices.
"""
from __future__ import annotations

import torch

NEG = -3.0e38


def gallery_match_ref(q, g, *, k: int = 5):
    """q: (Q, D), g: (N, D) — cosine top-k by full matmul + a stable sort.

    Mirrors the kernel's ``k > N`` contract: k is clamped to the gallery
    size and the trailing columns hold sentinels (-3e38, -1).  Ties go to
    the lowest gallery index, as ``jax.lax.top_k`` breaks them.
    """
    s = q.float() @ g.float().T
    k_eff = max(1, min(k, g.shape[0]))
    scores, idx = torch.sort(s, dim=1, descending=True, stable=True)
    scores, idx = scores[:, :k_eff], idx[:, :k_eff].to(torch.int32)
    if k_eff < k:
        Q = s.shape[0]
        scores = torch.cat([scores, scores.new_full((Q, k - k_eff), NEG)], 1)
        idx = torch.cat([idx, idx.new_full((Q, k - k_eff), -1)], 1)
    return scores, idx


def gallery_match_quant_ref(q, g_q, g_scale, *, k: int = 5):
    """int8-path oracle: match against the dequantized gallery in f32."""
    g = g_q.float() * g_scale.float()[:, None]
    return gallery_match_ref(q, g, k=k)
