"""Two-level ANN gallery matching (IVF-style): the Hopper rescore kernel,
its plain version, and the host-side codebook and cell layout.

The port of the reference's ``kernels/ann_match.py``.  The exact scan is
linear in N, so a very large watchlist is matched in two levels and only a
small, query-dependent fraction of the gallery is scored:

  level 1 — **coarse centroid scan** (``centroid_topc_cuda``): queries vs
      the K-row centroid codebook, keep the top-c cells per query.  It is
      the dense cosine top-k at codebook scale, so it runs the
      ``gallery_match`` kernel with k = c.

  level 2 — **exact rescore inside the probed cells**
      (``cell_rescore_cuda``): the shard is stored cell-major, each cell
      padded to ``L`` rows, as a (K*L, D) array in the storage dtype.  On a
      CUDA tensor the wrapper launches the kernel in ``csrc/cell_rescore.cu``
      (built with ``nvcc`` for ``sm_90a`` at first use, bound through
      ``ctypes``), which reads only the valid rows of the probed cells; on a
      CPU tensor it runs ``cell_rescore_plain``.  Any other device raises.

The rescore returns *padded positions* (cell * L + row); the caller owns the
padded-position -> gallery-row mapping (``CellLayout`` keeps it).  Ties
follow the reference kernel, not its oracle: among equal scores the earlier
probe slot wins, then the lower row in the cell.

``kmeans_lite``, ``assign_cells``, ``CellLayout``, ``build_cell_layout`` and
``pack_cells`` are host numpy, as in the reference, so codebooks,
assignments and layouts come out identical on the same rows.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.gallery_match import (MAX_D, MAX_K, NEG,
                                               gallery_match_cuda,
                                               gallery_match_quant_cuda,
                                               quantize_gallery)

__all__ = ["NEG", "CellLayout", "kmeans_lite", "assign_cells",
           "build_cell_layout", "pack_cells", "pack_cells_quant",
           "centroid_topc_cuda", "cell_rescore_cuda", "cell_rescore_plain"]

# launches of the CUDA rescore kernel (both passes count as one)
launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_lib = None


def build(verbose: bool = False):
    """Compile ``csrc/cell_rescore.cu`` unless already built; its path."""
    return _build.build("cell_rescore", verbose)


def _library():
    global _lib
    if _lib is None:
        lib = _build.library("cell_rescore")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.cr_rescore.argtypes = [ci, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci,
                                   ci, vp, vp, vp, vp, vp]
        lib.cr_rescore.restype = ci
        lib.cr_error_string.argtypes = [ci]
        lib.cr_error_string.restype = ctypes.c_char_p
        for fn in (lib.cr_max_k, lib.cr_max_d, lib.cr_chunk_rows):
            fn.argtypes, fn.restype = [], ci
        assert (lib.cr_max_k(), lib.cr_max_d()) == (MAX_K, MAX_D)
        _lib = lib
    return _lib


# ---------------------------------------------------------------------------
# level 1 — coarse centroid scan (dense top-c at codebook scale)
# ---------------------------------------------------------------------------
def centroid_topc_cuda(q: torch.Tensor, centroids: torch.Tensor,
                       c_scale: Optional[torch.Tensor] = None, *, c: int,
                       fuse_norm: bool = True):
    """Top-``c`` probe selection: q (Q, D) vs centroids (K, D) in the
    centroid storage dtype (fp32 / bf16, or int8 + per-row ``c_scale``).
    Returns (scores (Q, c) f32, cell ids (Q, c) i32); when ``c > K`` the
    trailing columns hold the (NEG, -1) sentinels — invalid probes, which
    the rescore masks."""
    if c_scale is not None:
        return gallery_match_quant_cuda(q, centroids, c_scale, k=c,
                                        fuse_norm=fuse_norm)
    return gallery_match_cuda(q, centroids, k=c, fuse_norm=fuse_norm)


# ---------------------------------------------------------------------------
# level 2 — exact rescore restricted to the probed cells
# ---------------------------------------------------------------------------
def cell_rescore_plain(q, cells, cell_ids, cell_lens, cell_scale=None, *,
                       k: int, L: int, fuse_norm: bool):
    """The kernel's function in plain PyTorch, on whatever device the
    tensors are on: the CPU path, and what the kernel is held against on
    the card.  Gathers the probed cells' rows in slot order into a
    (Q, c*L) block, scores it, masks pad rows and -1 probes, and takes a
    stable descending sort, so ties go to the lower column ``j*L + row``
    (earlier slot, then lower row), as in the kernel."""
    Q, D = q.shape
    c = cell_ids.shape[1]
    qf = q.float()
    if fuse_norm:
        qf = qf * torch.rsqrt(torch.clamp(
            (qf * qf).sum(dim=-1, keepdim=True), min=1e-18))
    ids = cell_ids.long()
    cid = ids.clamp(min=0)
    row = torch.arange(L, device=q.device)
    pos = (cid[:, :, None] * L + row).reshape(Q, c * L)    # slot-major
    s = (cells[pos].float() @ qf[:, :, None])[..., 0]       # (Q, c*L)
    if cell_scale is not None:
        s = s * cell_scale.float()[pos]
    n_valid = torch.where(ids >= 0, cell_lens.long()[cid], 0)
    live = (row[None, None, :] < n_valid[:, :, None]).reshape(Q, c * L)
    s = torch.where(live, s, torch.full_like(s, NEG))
    scores, key = torch.sort(s, dim=1, descending=True, stable=True)
    k_eff = min(k, c * L)
    scores, key = scores[:, :k_eff], key[:, :k_eff]
    out_pos = torch.gather(pos, 1, key)
    dead = scores <= NEG / 2
    scores = torch.where(dead, torch.full_like(scores, NEG), scores)
    out_pos = torch.where(dead, torch.full_like(out_pos, -1), out_pos)
    if k_eff < k:
        scores = torch.cat([scores, scores.new_full((Q, k - k_eff), NEG)], 1)
        out_pos = torch.cat([out_pos, out_pos.new_full((Q, k - k_eff), -1)],
                            1)
    return scores.contiguous(), out_pos.to(torch.int32).contiguous()


def _rescore_cuda(q, cells, cell_scale, ids, lens, k: int, L: int,
                  fuse_norm: bool):
    global launches
    Q, D = q.shape
    c = ids.shape[1]
    want_q = torch.bfloat16 if cells.dtype == torch.bfloat16 \
        else torch.float32
    if cells.dtype not in _DTYPE_CODE or q.dtype != want_q:
        raise ValueError(f"cell_rescore: no kernel for {q.dtype} queries on "
                         f"{cells.dtype} cells")
    if D > MAX_D:
        raise ValueError(f"cell_rescore: D={D} above the kernel's {MAX_D}")
    if k > MAX_K:
        raise ValueError(f"cell_rescore: k={k} above the kernel's {MAX_K}")
    if not all(t.is_contiguous() for t in (q, cells, ids, lens)) or (
            cell_scale is not None and not cell_scale.is_contiguous()):
        raise ValueError("cell_rescore: inputs must be contiguous")
    lib = _library()
    dev = q.device
    chunks = -(-L // lib.cr_chunk_rows())
    part_s = torch.empty((Q, c, chunks, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((Q, c, chunks, k), dtype=torch.int32, device=dev)
    out_s = torch.empty((Q, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((Q, k), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.cr_rescore(
            _DTYPE_CODE[cells.dtype], q.data_ptr(), cells.data_ptr(),
            cell_scale.data_ptr() if cell_scale is not None else None,
            ids.data_ptr(), lens.data_ptr(), Q, c, D, L, k, int(fuse_norm),
            part_s.data_ptr(), part_i.data_ptr(), out_s.data_ptr(),
            out_i.data_ptr(), stream)
    if err != 0:
        raise RuntimeError("cell_rescore: kernel launch failed: "
                           + lib.cr_error_string(err).decode())
    launches += 1
    return out_s, out_i


def cell_rescore_cuda(q: torch.Tensor, cells: torch.Tensor,
                      cell_ids: torch.Tensor, cell_lens: torch.Tensor,
                      cell_scale: Optional[torch.Tensor] = None, *,
                      k: int = 5, L: int, fuse_norm: bool = True):
    """Exact rescore of q (Q, D) against its probed cells only.

    ``cells``: (K*L, D) padded cell-major gallery in the storage dtype
    (fp32 / bf16, or int8 with fp32 ``cell_scale`` (K*L,)); ``cell_ids``:
    (Q, c) probe table from the coarse scan (-1 = no probe); ``cell_lens``:
    (K,) valid rows per cell.  Returns (scores (Q, k) f32, padded positions
    (Q, k) i32) with (NEG, -1) in unfilled slots.  bf16 cells cast the
    query to bf16; int8 keeps it in fp32."""
    if q.dim() != 2 or cells.dim() != 2 or q.shape[1] != cells.shape[1]:
        raise ValueError(f"cell_rescore: bad shapes q{tuple(q.shape)} "
                         f"cells{tuple(cells.shape)}")
    if cell_ids.dim() != 2 or cell_ids.shape[0] != q.shape[0] \
            or cell_ids.shape[1] < 1 or q.shape[0] < 1:
        raise ValueError(f"cell_rescore: bad probe table "
                         f"{tuple(cell_ids.shape)} for {q.shape[0]} queries")
    K = cell_lens.shape[0]
    if L < 1 or cells.shape[0] != K * L:
        raise ValueError(f"cell_rescore: cells{tuple(cells.shape)} is not "
                         f"{K} cells of L={L} rows")
    if k < 1:
        raise ValueError(f"cell_rescore: k={k}")
    if cell_scale is not None:
        if cells.dtype != torch.int8 or cell_scale.dtype != torch.float32 \
                or tuple(cell_scale.shape) != (cells.shape[0],):
            raise ValueError("cell_rescore: the quantized path takes int8 "
                             "cells and fp32 scales (K*L,)")
        q = q.float()
    elif cells.dtype == torch.bfloat16:
        q = q.to(torch.bfloat16)
    else:
        q, cells = q.float(), cells.float()
    ids, lens = cell_ids.to(torch.int32), cell_lens.to(torch.int32)
    tensors = (q, cells, ids, lens) + ((cell_scale,) if cell_scale
                                       is not None else ())
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"cell_rescore: tensors on several devices {devs}")
    if q.device.type == "cpu":
        return cell_rescore_plain(q, cells, ids, lens, cell_scale, k=k, L=L,
                                  fuse_norm=fuse_norm)
    if q.device.type == "cuda":
        return _rescore_cuda(q.contiguous(), cells.contiguous(),
                             cell_scale, ids.contiguous(), lens.contiguous(),
                             k, L, fuse_norm)
    raise ValueError(f"cell_rescore: no kernel for device {q.device}")


# ---------------------------------------------------------------------------
# codebook training + cell layout (host side, enrollment time)
# ---------------------------------------------------------------------------
def kmeans_lite(x: np.ndarray, n_cells: int, *, iters: int = 6,
                seed: int = 0) -> np.ndarray:
    """Spherical k-means-lite: train an (n_cells, D) L2-normalized
    centroid codebook over L2-normalized rows ``x``.  Deterministic
    (seeded row-sample init); an emptied cell keeps its previous
    centroid so the codebook never collapses.  Host-side numpy — this
    runs once per codebook at enrollment time, not in the match path."""
    x = np.asarray(x, np.float32)
    n = x.shape[0]
    n_cells = max(1, min(n_cells, n))
    rng = np.random.default_rng(seed)
    cent = x[rng.choice(n, n_cells, replace=False)].copy()
    for _ in range(iters):
        assign = np.argmax(x @ cent.T, axis=1)
        for cell in range(n_cells):
            rows = x[assign == cell]
            if len(rows):
                m = rows.sum(axis=0)
                norm = np.linalg.norm(m)
                if norm > 1e-9:
                    cent[cell] = m / norm
    return cent


def assign_cells(x: np.ndarray, centroids: np.ndarray) -> np.ndarray:
    """Nearest-centroid (cosine) cell id per row — the incremental-enroll
    path: new rows join existing cells, the codebook is never retrained."""
    xn = np.asarray(x, np.float32)
    xn = xn / np.maximum(np.linalg.norm(xn, axis=-1, keepdims=True), 1e-9)
    return np.argmax(xn @ np.asarray(centroids, np.float32).T,
                     axis=1).astype(np.int32)


@dataclass
class CellLayout:
    """Padded cell-major physical layout of one gallery shard.

    ``perm``: (N,) shard-row id at each occupied padded slot, cell-major;
    ``pos_to_row``: (K*L,) shard-row id per padded position (-1 = pad);
    ``cell_lens``: (K,) occupancy; ``L``: pad width (max cell size,
    rounded up to a multiple of 8 so cell tiles stay sublane-aligned).
    """
    perm: np.ndarray
    pos_to_row: np.ndarray
    cell_lens: np.ndarray
    L: int

    @property
    def n_cells(self) -> int:
        return len(self.cell_lens)


def build_cell_layout(assign: np.ndarray, n_cells: int) -> CellLayout:
    """Group shard rows by cell id into the padded cell-major layout the
    rescore kernel streams.  O(N log N) host-side repack; stable within a
    cell (rows keep enrollment order, so in-cell score ties break toward
    the earliest-enrolled row, same as the dense kernel)."""
    assign = np.asarray(assign, np.int64)
    cell_lens = np.bincount(assign, minlength=n_cells).astype(np.int32)
    L = max(8, int(-(-max(1, cell_lens.max(initial=1)) // 8) * 8))
    perm = np.argsort(assign, kind="stable").astype(np.int64)
    pos_to_row = np.full(n_cells * L, -1, np.int64)
    starts = np.concatenate([[0], np.cumsum(cell_lens)[:-1]])
    for cell in range(n_cells):
        rows = perm[starts[cell]:starts[cell] + cell_lens[cell]]
        pos_to_row[cell * L:cell * L + len(rows)] = rows
    return CellLayout(perm=perm, pos_to_row=pos_to_row,
                      cell_lens=cell_lens, L=L)


def pack_cells(gn: np.ndarray, layout: CellLayout) -> np.ndarray:
    """Scatter normalized shard rows (N, D) into the (K*L, D) padded
    cell-major array (pad rows zero — masked in-kernel via cell_lens)."""
    out = np.zeros((layout.n_cells * layout.L, gn.shape[1]), np.float32)
    occ = layout.pos_to_row >= 0
    out[occ] = np.asarray(gn, np.float32)[layout.pos_to_row[occ]]
    return out


def pack_cells_quant(gn: np.ndarray, layout: CellLayout):
    """int8 packed cells: symmetric per-row quantization of the packed
    array (pad rows quantize to zeros with the minimum scale, and are
    masked by the kernel anyway)."""
    q8, scale = quantize_gallery(torch.from_numpy(pack_cells(gn, layout)))
    return q8.numpy(), scale.numpy()
