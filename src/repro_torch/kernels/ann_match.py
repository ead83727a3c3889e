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
probe slot wins, then the lower row in the cell.  Both levels take any k
(or c) and any row width: above ``MAX_K`` a call runs several rounds of
the kernel, each finding the next ``MAX_K`` entries (``rounds``).

``kmeans_lite``, ``assign_cells``, ``CellLayout``, ``build_cell_layout`` and
``pack_cells`` are host numpy, as in the reference, so codebooks,
assignments and layouts come out identical on the same rows.
"""
from __future__ import annotations

import contextlib
import ctypes
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.gallery_match import (MAX_D, MAX_K, NEG,
                                               gallery_match_cuda,
                                               gallery_match_quant_cuda,
                                               quantize_gallery, rounds)

__all__ = ["NEG", "CellLayout", "kmeans_lite", "assign_cells",
           "build_cell_layout", "pack_cells", "pack_cells_quant",
           "centroid_topc_cuda", "cell_rescore_cuda", "cell_rescore_plain"]

# launches of the CUDA rescore kernel (a call counts one a round on either
# path), and the plan (path, warps a block, rows a warp, passes, blocks,
# rounds) of the last call
launches = 0
last_plan = None

FUSED_D = 128           # the one row width the fused path takes
MAX_WARPS = 4           # its most warps a block (kMaxWarps in the .cu)
CHUNK_ROWS = 32         # the two-pass path's rows a block (kRows in the .cu)
_WARP_ROWS = {4: 16, 2: 16, 1: 32}   # rows a warp on the fused path, by the
                                     # cells' itemsize (cr_warp_rows)
_WIDE_WARPS_PER_SM = 32    # the most warps an SM the plan puts in flight
                           # at once, each with all its rows
_NARROW_WARPS_PER_SM = 16  # past that: one-warp blocks, about this many an
_MIN_PASSES = 4            # SM, each making at least this many passes

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_FP32_Q_BF16_CELLS = 3  # the fused path rounds an fp32 query to bf16 itself
_vp, _ci = ctypes.c_void_p, ctypes.c_int
# the C interface of csrc/cell_rescore.cu: (argument types, result type)
_SIGNATURES = {
    "cr_rescore": ([_ci, _vp, _vp, _vp, _vp, _vp, _ci, _ci, _ci, _ci, _ci,
                    _ci, _vp, _vp, _vp, _vp, _vp], _ci),
    "cr_rescore_fused": ([_ci, _vp, _vp, _vp, _vp, _vp, _ci, _ci, _ci, _ci,
                          _ci, _ci, _ci, _ci, _ci, _vp, _vp, _vp, _vp, _vp,
                          _vp], _ci),
    "cr_empty": ([_ci, _ci, _vp], _ci),
    "cr_error_string": ([_ci], ctypes.c_char_p),
    "cr_max_k": ([], _ci),
    "cr_max_d": ([], _ci),
    "cr_chunk_rows": ([], _ci),
    "cr_max_warps": ([], _ci),
    "cr_warp_rows": ([_ci], _ci),
}
_lib = None


def build(verbose: bool = False):
    """Compile ``csrc/cell_rescore.cu`` unless already built; its path."""
    return _build.build("cell_rescore", verbose)


def _library():
    global _lib
    if _lib is None:
        lib = _build.library("cell_rescore")
        for name, (args, res) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, res
        assert (lib.cr_max_k(), lib.cr_max_d(), lib.cr_chunk_rows(),
                lib.cr_max_warps()) == (MAX_K, MAX_D, CHUNK_ROWS, MAX_WARPS)
        assert all(lib.cr_warp_rows(code) == _WARP_ROWS[dt.itemsize]
                   for dt, code in _DTYPE_CODE.items())
        _lib = lib
    return _lib


def plan(Q: int, c: int, L: int, D: int, itemsize: int, aligned: bool,
         sms: int, k: int):
    """How a call at ``k`` is launched: (path, warps a block, rows a warp,
    passes a block, blocks); all ``rounds(k)`` rounds of the call take
    that path.

    ``"fused"`` for k <= ``MAX_K`` and rows of ``FUSED_D`` values in a
    16-byte aligned array, in one round:
    a warp takes 16 / 16 / 32 rows (fp32 / bf16 / int8) of one (query,
    slot) pair's cell, with all their loads in flight at once.  While the
    call's rows need at most ``_WIDE_WARPS_PER_SM`` warps an SM (``sms``),
    they are all in flight together: blocks of ``MAX_WARPS`` warps (fewer
    if the cell has fewer rows) over consecutive rows, one pass each.  A
    larger call takes one-warp blocks, about ``_NARROW_WARPS_PER_SM`` an
    SM, each making passes (at least ``_MIN_PASSES``) over the next rows
    of its cell, so fewer blocks and lists carry the arrival and the
    merge.  ``"two_pass"`` otherwise, at any k and D: the two-pass kernels,
    one warp a block of ``CHUNK_ROWS`` rows, in ``rounds(k)`` rounds (rows
    wider than ``MAX_D`` a chunk of ``MAX_D`` values at a time)."""
    if D == FUSED_D and aligned and k <= MAX_K:
        rows = _WARP_ROWS[itemsize]
        warps = MAX_WARPS
        while warps > 1 and (warps // 2) * rows >= L:
            warps //= 2
        chunks = -(-L // (warps * rows))
        if Q * c * chunks * warps <= _WIDE_WARPS_PER_SM * sms:
            return "fused", warps, rows, 1, Q * c * chunks
        groups = -(-L // rows)
        fit = max(1, _NARROW_WARPS_PER_SM * sms // (Q * c))
        passes = min(groups, max(_MIN_PASSES, -(-groups // fit)))
        return "fused", 1, rows, passes, Q * c * -(-L // (passes * rows))
    return "two_pass", 1, CHUNK_ROWS, 1, Q * c * -(-L // CHUNK_ROWS)


_sms = {}
_scratch = {}


def _sm_count(dev) -> int:
    if dev.index not in _sms:
        _sms[dev.index] = torch.cuda.get_device_properties(dev) \
            .multi_processor_count
    return _sms[dev.index]


def _scratch_for(dev, stream: int, n_part: int, Q: int):
    """(partials, arrival counts, best words) for ``dev`` and ``stream``,
    kept across calls and grown to hold ``n_part`` partial entries of 8
    bytes and ``Q`` counts and words.  The counts and words are zeroed when
    they are made; every launch that completes leaves them at 0."""
    key = (dev.index, stream)
    part, counts, best = _scratch.get(key, (None,) * 3)
    if part is None or part.numel() < n_part:
        part = torch.empty(1 << max(10, (n_part - 1).bit_length()),
                           dtype=torch.int64, device=dev)
    if counts is None or counts.numel() < Q:
        n = 1 << max(6, (Q - 1).bit_length())
        counts = torch.zeros(n, dtype=torch.int32, device=dev)
        best = torch.zeros(n, dtype=torch.int64, device=dev)
    _scratch[key] = (part, counts, best)
    return part, counts, best


def empty_launch(dev, blocks: int, warps: int) -> None:
    """Launch the empty kernel on ``blocks`` blocks of ``warps`` warps (the
    latency floor a call of that grid cannot beat; not counted in
    ``launches``)."""
    lib = _library()
    err = lib.cr_empty(blocks, 32 * warps,
                       torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError("cell_rescore: empty launch failed: "
                           + lib.cr_error_string(err).decode())


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
    global launches, last_plan
    Q, D = q.shape
    c = ids.shape[1]
    lib = _library()
    dev = q.device
    path, warps, rows, passes, blocks = plan(
        Q, c, L, D, cells.element_size(), cells.data_ptr() % 16 == 0,
        _sm_count(dev), k)
    n_rounds = rounds(k)
    code = _DTYPE_CODE[cells.dtype]
    if code == 1 and q.dtype == torch.float32:
        if path == "fused":
            code = _FP32_Q_BF16_CELLS
        else:
            q = q.to(torch.bfloat16)
    out_s = torch.empty((Q, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((Q, k), dtype=torch.int32, device=dev)
    with (torch.cuda.device(dev) if dev.index != torch.cuda.current_device()
          else contextlib.nullcontext()):
        stream = torch.cuda.current_stream(dev).cuda_stream
        k_round = min(k, MAX_K)            # a round's partials
        part, counts, best = _scratch_for(dev, stream, blocks * k_round, Q)
        args = (q.data_ptr(), cells.data_ptr(),
                cell_scale.data_ptr() if cell_scale is not None else None,
                ids.data_ptr(), lens.data_ptr(), Q, c, D, L, k,
                int(fuse_norm))
        if path == "fused":
            err = lib.cr_rescore_fused(
                code, *args, warps, passes, blocks // (Q * c),
                part.data_ptr(), counts.data_ptr(), best.data_ptr(),
                out_s.data_ptr(), out_i.data_ptr(), stream)
            if err != 0:
                counts.zero_()
                best.zero_()
        else:                 # partial scores, then keys, in the scratch
            err = lib.cr_rescore(code, *args, part.data_ptr(),
                                 part.data_ptr() + 4 * blocks * k_round,
                                 out_s.data_ptr(), out_i.data_ptr(), stream)
    if err != 0:
        raise RuntimeError("cell_rescore: kernel launch failed: "
                           + lib.cr_error_string(err).decode())
    launches += n_rounds
    last_plan = (path, warps, rows, passes, blocks, n_rounds)
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
    query to bf16 (the fused path's kernel does so itself); int8 keeps it
    in fp32.  Inputs already of these dtypes and contiguous are used as
    they are."""
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
    elif cells.dtype != torch.bfloat16 and cells.dtype != torch.float32:
        cells = cells.float()
    dev = q.device
    for t in (cells, cell_ids, cell_lens, cell_scale):
        if t is not None and t.device != dev:
            raise ValueError(f"cell_rescore: tensors on several devices "
                             f"{dev} and {t.device}")
    if cells.dtype == torch.bfloat16:
        # on the card the fused kernel rounds an fp32 query to bf16 itself
        if q.dtype != torch.bfloat16 and (dev.type != "cuda"
                                          or q.dtype != torch.float32):
            q = q.to(torch.bfloat16)
    elif q.dtype != torch.float32:
        q = q.float()
    ids = cell_ids if cell_ids.dtype == torch.int32 \
        else cell_ids.to(torch.int32)
    lens = cell_lens if cell_lens.dtype == torch.int32 \
        else cell_lens.to(torch.int32)
    if dev.type == "cpu":
        return cell_rescore_plain(q, cells, ids, lens, cell_scale, k=k, L=L,
                                  fuse_norm=fuse_norm)
    if dev.type == "cuda":
        q, cells, ids, lens = (t if t.is_contiguous() else t.contiguous()
                               for t in (q, cells, ids, lens))
        if cell_scale is not None and not cell_scale.is_contiguous():
            cell_scale = cell_scale.contiguous()
        return _rescore_cuda(q, cells, cell_scale, ids, lens, k, L,
                             fuse_norm)
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
