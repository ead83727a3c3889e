"""Plain PyTorch oracles for the kernels (the correctness contract).

Ports of the reference's ``kernels/ref.py``: the match and ANN oracles,
and the LM oracles ``flash_attention_ref`` (right-aligned causal mask, as
the reference's; the flash kernel itself is left-aligned, ROADMAP R4) and
``mamba2_ssd_ref`` (the sequential recurrence).  ``jax.lax.top_k`` breaks
ties by the lowest index, which a stable descending sort gives.
"""
from __future__ import annotations

import torch

NEG = -3.0e38


def _top_k(s, k: int):
    """Top-k of each row: score descending, lowest index first on ties."""
    scores, idx = torch.sort(s, dim=1, descending=True, stable=True)
    return scores[:, :k], idx[:, :k]


def _l2n(x):
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=1e-9)


def _sentinels(scores, idx):
    dead = scores <= NEG / 2
    return (torch.where(dead, torch.full_like(scores, NEG), scores),
            torch.where(dead, torch.full_like(idx, -1), idx).to(torch.int32))


def gallery_match_ref(q, g, *, k: int = 5):
    """q: (Q, D), g: (N, D) — cosine top-k by full matmul + a stable sort.

    Mirrors the kernel's ``k > N`` contract: k is clamped to the gallery
    size and the trailing columns hold sentinels (-3e38, -1).  Ties go to
    the lowest gallery index, as ``jax.lax.top_k`` breaks them.
    """
    s = q.float() @ g.float().T
    k_eff = max(1, min(k, g.shape[0]))
    scores, idx = _top_k(s, k_eff)
    idx = idx.to(torch.int32)
    if k_eff < k:
        Q = s.shape[0]
        scores = torch.cat([scores, scores.new_full((Q, k - k_eff), NEG)], 1)
        idx = torch.cat([idx, idx.new_full((Q, k - k_eff), -1)], 1)
    return scores, idx


def gallery_match_quant_ref(q, g_q, g_scale, *, k: int = 5):
    """int8-path oracle: match against the dequantized gallery in f32."""
    g = g_q.float() * g_scale.float()[:, None]
    return gallery_match_ref(q, g, k=k)


def centroid_topc_ref(q, centroids, *, c: int):
    """Coarse-scan oracle: top-``c`` cells by cosine (same contract as
    ``gallery_match_ref`` — ``c > K`` pads with (-3e38, -1) sentinels)."""
    return gallery_match_ref(q, centroids, k=c)


def cell_rescore_ref(q, cells, cell_ids, cell_lens, *, k: int, L: int):
    """Rescore oracle in the padded cell-major layout: score q (Q, D)
    against the (K*L, D) packed array, mask pad rows (row >= cell_len)
    and every position outside each query's probed cells, then top-k.
    Returns (scores (Q, k) f32, padded positions (Q, k) i32) with
    (-3e38, -1) sentinels for unfilled slots.  Ties go to the lowest
    padded position (the kernel's own order is by probe slot, then row)."""
    s = _l2n(q.float()) @ cells.float().T                 # (Q, K*L)
    K = cell_lens.shape[0]
    pos = torch.arange(K * L, device=s.device)
    pos_cell, pos_row = pos // L, pos % L
    occupied = pos_row < cell_lens.long()[pos_cell]       # (K*L,)
    probed = (cell_ids.long()[:, :, None] == pos_cell[None, None, :]) \
        .any(dim=1)                                       # (Q, K*L)
    s = torch.where(probed & occupied[None, :], s, torch.full_like(s, NEG))
    return _sentinels(*_top_k(s, k))


def ann_match_ref(q, gn, centroids, assign, *, nprobe: int, k: int):
    """End-to-end two-level oracle against the *flat* shard gallery:
    probe the top-``nprobe`` cells per query, then exact top-k restricted
    to gallery rows assigned to a probed cell.  Returns (scores, row ids)
    with (-3e38, -1) sentinels when fewer than k rows were probed."""
    qn = _l2n(q.float())
    _, cells = centroid_topc_ref(qn, centroids, c=nprobe)
    probed = (assign.long()[None, None, :] == cells.long()[:, :, None]) \
        .any(dim=1)                                       # (Q, N)
    s = qn @ gn.float().T
    s = torch.where(probed, s, torch.full_like(s, NEG))
    scores, idx = _top_k(s, min(k, gn.shape[0]))
    if scores.shape[1] < k:
        pad = k - scores.shape[1]
        scores = torch.cat([scores, scores.new_full((s.shape[0], pad), NEG)],
                           1)
        idx = torch.cat([idx, idx.new_full((s.shape[0], pad), -1)], 1)
    return _sentinels(scores, idx)


def flash_attention_ref(q, k, v, *, causal=True, scale=None, window=0):
    """q: (B,H,Sq,D), k/v: (B,Kh,Sk,D[v]). Plain softmax attention, f32."""
    B, H, Sq, D = q.shape
    Kh, Sk = k.shape[1], k.shape[2]
    G = H // Kh
    scale = scale if scale is not None else D ** -0.5
    qg = q.float().reshape(B, Kh, G, Sq, D)
    s = torch.einsum("bkgqd,bksd->bkgqs", qg, k.float()) * scale
    qpos = torch.arange(Sq, device=q.device)[:, None] + (Sk - Sq)
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window:
        mask &= qpos - kpos < window
    s = torch.where(mask, s, torch.full_like(s, -2e38))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bksd->bkgqd", p, v.float())
    return o.reshape(B, H, Sq, v.shape[-1])


def mamba2_ssd_ref(x, dt, A, B, C, D=None, *, init_state=None):
    """Sequential SSD recurrence (Mamba-2), the exactness oracle.

    x: (Bt, L, H, P)  dt: (Bt, L, H)  A: (H,)  B,C: (Bt, L, N)
    state: (Bt, H, P, N); y[t] = C[t] . state[t]  (+ D*x skip).
    """
    Bt, L, H, P = x.shape
    N = B.shape[-1]
    st = (init_state.float() if init_state is not None else
          torch.zeros((Bt, H, P, N), dtype=torch.float32, device=x.device))
    xf, dtf, Bf, Cf = x.float(), dt.float(), B.float(), C.float()
    A = A.float()
    ys = []
    for t in range(L):
        dA = torch.exp(dtf[:, t] * A[None, :])                  # (Bt,H)
        dBx = torch.einsum("bhp,bn->bhpn", xf[:, t] * dtf[:, t, :, None],
                           Bf[:, t])
        st = st * dA[..., None, None] + dBx
        ys.append(torch.einsum("bhpn,bn->bhp", st, Cf[:, t]))
    y = torch.stack(ys, dim=1)                                  # (Bt,L,H,P)
    if D is not None:
        y = y + xf * D.float()[None, None, :, None]
    return y, st
