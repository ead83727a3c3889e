"""The cell-rescore kernel's launch plan, row partition, scratch cache and C
interface, on the CPU.

The kernel itself runs only on the card, where ``chip_smoke.py`` holds it
against its plain version; ``tests/test_torch_ann.py`` holds that plain
version against the reference's Pallas kernel.  Here: the pure ``plan``
function, a numpy model of how the fused path's grid splits the probed
cells' rows among warps (the index arithmetic of ``rescore_fused_kernel``),
the per-(device, stream) scratch cache, and the ctypes signatures against
the C source.  No tolerances: everything compared is exact.
"""
import ctypes
import pathlib
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import ann_match as A

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = ROOT / "src/repro_torch/kernels/csrc/cell_rescore.cu"
INT_MAX = 2**31 - 1


@pytest.mark.parametrize("sms", [132, 7])
@pytest.mark.parametrize("itemsize", [4, 2, 1])
def test_plan_takes_the_fused_path_only_for_aligned_128_wide_rows(sms,
                                                                  itemsize):
    """D = 128 with an aligned array: the fused path, 16 / 16 / 32 rows a
    warp.  While the call needs at most _WIDE_WARPS_PER_SM warps an SM to
    have every row in flight: blocks of 4 warps (fewer if the cell has
    fewer rows than half of them), one pass each.  Beyond: one-warp blocks
    making the fewest passes, at least _MIN_PASSES, that keep them within
    _NARROW_WARPS_PER_SM warps an SM.  Always enough blocks to cover L
    rows of every (query, slot) pair.  Any other width, or a misaligned
    array: the two-pass path, one pass."""
    for Q in (1, 2, 16, 256):
        for c in (1, 8, 16):
            for L in (8, 16, 24, 64, 376, 400, 2048):
                path, W, R, P, blocks = A.plan(Q, c, L, A.FUSED_D, itemsize,
                                               True, sms, A.MAX_K)
                assert path == "fused" and R == A._WARP_ROWS[itemsize]
                chunks = -(-L // (P * W * R))
                assert blocks == Q * c * chunks
                assert (chunks - 1) * P * W * R < L <= chunks * P * W * R
                wide = A.MAX_WARPS
                while wide > 1 and (wide // 2) * R >= L:
                    wide //= 2
                groups = -(-L // R)
                if Q * c * -(-L // (wide * R)) * wide <= \
                        A._WIDE_WARPS_PER_SM * sms:
                    assert (W, P) == (wide, 1)
                else:
                    fit = max(1, A._NARROW_WARPS_PER_SM * sms // (Q * c))
                    assert (W, P) == (1, min(groups, max(
                        A._MIN_PASSES, -(-groups // fit))))
                    assert P >= min(groups, A._MIN_PASSES)
                for D, aligned in ((36, True), (260, True), (64, True),
                                   (A.FUSED_D, False)):
                    plan = A.plan(Q, c, L, D, itemsize, aligned, sms, 1)
                    assert plan == ("two_pass", 1, A.CHUNK_ROWS, 1,
                                    Q * c * -(-L // A.CHUNK_ROWS))


def test_plan_at_the_serving_shape():
    """One query, 8 probes of cells padded to a few hundred rows, on an
    H100's 132 SMs: blocks of 4 warps, one pass each, every row of the
    call in flight at once (48 / 48 / 32 blocks in fp32 / bf16 / int8);
    so at 16 queries.  256 queries take one one-warp block a pair, passing
    over the whole cell."""
    for itemsize, L, want in ((4, 376, (4, 16, 1, 48)),
                              (2, 384, (4, 16, 1, 48)),
                              (1, 400, (4, 32, 1, 32))):
        assert A.plan(1, 8, L, 128, itemsize, True, 132, 1) == \
            ("fused",) + want
        path, W, R, P, blocks = A.plan(16, 8, L, 128, itemsize, True, 132, 1)
        assert (W, P, blocks) == (4, 1, 16 * want[3])
        path, W, R, P, blocks = A.plan(256, 8, L, 128, itemsize, True, 132,
                                       1)
        assert (W, P, blocks) == (1, -(-L // R), 256 * 8)


@pytest.mark.parametrize("itemsize", [4, 2, 1])
def test_plan_grid_within_launch_limits(itemsize):
    """Up to Q * c = 4096 (query, slot) pairs and cells of up to 4096
    rows: the grid, the keys slot * L + row and the merge's partial count
    fit the kernel's int arithmetic and the launch's x dimension."""
    for Q, c in ((256, 16), (4096, 1), (64, 64), (1, 4096)):
        for L in (8, 376, 4096):
            for path_d, aligned in ((A.FUSED_D, True), (36, True)):
                path, W, R, P, blocks = A.plan(Q, c, L, path_d, itemsize,
                                               aligned, 132, A.MAX_K)
                assert 1 <= blocks <= INT_MAX
                assert c * L <= INT_MAX
                assert blocks // Q * A.MAX_K <= INT_MAX
                assert blocks * A.MAX_K < 2**40


def _partition(Q, c, L, lens, ids, W, R, P, chunks):
    """A numpy model of ``rescore_fused_kernel``'s index arithmetic: (times
    each (pair, row) is given to a warp, the query each block's partial
    slot belongs to)."""
    hits = np.zeros((Q * c, L), np.int64)
    part_query = np.full(Q * c * chunks, -1, np.int64)
    for b in range(Q * c * chunks):
        pair, chunk = divmod(b, chunks)
        cid = ids.reshape(-1)[pair]
        n_valid = 0 if cid < 0 else lens[cid]
        part_query[b] = pair // c
        b0 = chunk * P * W * R
        for ps in range(P):
            if b0 + ps * W * R >= n_valid:
                break                         # the block is done
            for w in range(W):
                w0 = b0 + ps * W * R + w * R
                if w0 >= n_valid:
                    continue                  # the warp loads nothing
                # steps of 4 rows, lane row p of each step, predicated on
                # row < n_valid (loads and the owner's offer alike)
                for s in range(R // 4):
                    for p in range(4):
                        row = w0 + 4 * s + p
                        if row < n_valid:
                            hits[pair, row] += 1
    return hits, part_query


@pytest.mark.parametrize("itemsize", [4, 2, 1])
@pytest.mark.parametrize("Q,c", [(1, 8), (3, 5), (16, 16), (2, 40)])
def test_fused_partition_gives_every_valid_row_to_one_warp(Q, c, itemsize):
    """Ragged cells (empty ones, lengths at exact multiples of a warp's
    and a block's rows, a full cell) and -1 probes, with one pass a block
    and with several: every valid row of every probed cell goes to
    exactly one warp, no pad row and no row of a -1 probe to any, and the
    partials of a query's c * chunks blocks are the query's contiguous
    share of the scratch."""
    rng = np.random.default_rng(Q * 100 + c + itemsize)
    R = A._WARP_ROWS[itemsize]
    K = 48
    L = 9 * R + 8
    lens = rng.integers(0, L + 1, K)
    lens[:6] = [0, R, 2 * R, 4 * R, L, 1]
    ids = np.stack([rng.permutation(K)[:c] for _ in range(Q)]) \
        .astype(np.int32)
    ids[0, :min(c, 6)] = np.arange(min(c, 6))
    ids[-1, -1] = -1
    for sms in (132, 1):
        path, W, R2, P, blocks = A.plan(Q, c, L, A.FUSED_D, itemsize, True,
                                        sms, 5)
        assert path == "fused" and R2 == R
        chunks = blocks // (Q * c)
        hits, part_query = _partition(Q, c, L, lens, ids, W, R, P, chunks)
        flat = ids.reshape(-1)
        n_valid = np.where(flat >= 0, lens[np.clip(flat, 0, None)], 0)
        want = (np.arange(L)[None, :] < n_valid[:, None]).astype(np.int64)
        np.testing.assert_array_equal(hits, want)
        # block b's partial lies at b * k: query qi owns blocks
        # [qi * c * chunks, (qi + 1) * c * chunks), as the last block reads
        np.testing.assert_array_equal(
            part_query, np.repeat(np.arange(Q), c * chunks))
    assert P > 1                              # sms = 1 folds passes


def test_scratch_is_kept_per_device_and_stream_and_grows(monkeypatch):
    """The partials (8-byte entries), arrival counts and best words are
    made once per (device, stream) and reused; a larger call grows them;
    the counts and words start at 0."""
    monkeypatch.setattr(A, "_scratch", {})
    cpu = torch.device("cpu")
    first = part, counts, best = A._scratch_for(cpu, 7, 100, 3)
    assert part.numel() >= 100 and counts.numel() >= 3 and best.numel() >= 3
    assert part.dtype == best.dtype == torch.int64
    assert counts.dtype == torch.int32
    assert not counts.any() and not best.any()
    again = A._scratch_for(cpu, 7, 50, 2)
    assert all(a is b for a, b in zip(again, first))
    other = A._scratch_for(cpu, 8, 100, 3)
    assert all(a is not b for a, b in zip(other, first))
    bigger_q = A._scratch_for(cpu, 7, 100, 300)
    assert bigger_q[1].numel() >= 300 and bigger_q[2].numel() >= 300
    assert not bigger_q[1].any() and not bigger_q[2].any()
    assert bigger_q[0] is part
    bigger = A._scratch_for(cpu, 7, 10_000, 300)
    assert bigger[0].numel() >= 10_000
    assert bigger[1] is bigger_q[1] and bigger[2] is bigger_q[2]
    assert set(A._scratch) == {(None, 7), (None, 8)}


def _c_params(src: str, name: str) -> list:
    m = re.search(r"\b" + name + r"\(([^)]*)\)\s*\{", src)
    assert m, name
    return [p.strip() for p in m.group(1).split(",") if p.strip()]


def test_c_interface_matches_the_wrapper():
    """Each C function of csrc/cell_rescore.cu takes as many arguments, of
    the same kinds, as the ctypes signature the wrapper sets, and the
    wrapper's constants are the kernel's."""
    src = SRC.read_text()
    kind = {ctypes.c_void_p: "pointer", ctypes.c_int: "int"}
    for name, (args, _) in A._SIGNATURES.items():
        params = _c_params(src, name)
        assert len(params) == len(args), (name, params)
        for p, a in zip(params, args):
            want = "pointer" if "*" in p else "int"
            assert kind.get(a, "pointer") == want, (name, p, a)
    assert re.search(r"constexpr int kMaxWarps = (\d+);", src).group(1) == \
        str(A.MAX_WARPS)
    assert re.search(r"constexpr int kRows = (\d+);", src).group(1) == \
        str(A.CHUNK_ROWS)
    header = (SRC.parent / "match_common.cuh").read_text()
    loads = int(re.search(r"constexpr int kLoads = (\d+);", header).group(1))
    row_d = int(re.search(r"constexpr int kRowD = (\d+);", header).group(1))
    assert row_d == A.FUSED_D
    groups = int(re.search(r"constexpr int kFp32Groups = (\d+);", src)
                 .group(1))
    group_rows = {i: 32 * loads * 16 // (row_d * i) for i in (4, 2, 1)}
    assert A._WARP_ROWS == {4: groups * group_rows[4], 2: group_rows[2],
                            1: group_rows[1]}


def test_the_match_kernels_share_one_row_layout():
    """``widen`` and ``row_sums`` live once, in the shared header, and both
    match kernels use them."""
    csrc = SRC.parent
    header = (csrc / "match_common.cuh").read_text()
    for fn in ("widen(", "row_sums(", "struct RowGroup"):
        assert fn in header
    for name in ("gallery_match.cu", "cell_rescore.cu"):
        src = (csrc / name).read_text()
        assert "void widen(" not in src and "float row_sums(" not in src
        assert "row_sums<" in src and "RowGroup<" in src
