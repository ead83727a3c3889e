#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing its lines; any failure exits non-zero:

1. card: the GPU's name and power limit, from nvidia-smi;
2. build: compile both CUDA kernels from ``src/repro_torch/kernels/csrc``
   (one nvcc each for sm_90a, started together) and print each build time;
3. gallery-match kernel vs plain: the kernel against its plain PyTorch
   version on the card, for fp32, bf16 and int8 galleries at Q in
   {1, 16, 256}, N in {1000, 262144}, D = 128, k in {1, 5}, plus k > N and
   galleries that take the kernel's element-wise load path; then the
   kernel's, the plain version's and ``torch.topk(q @ g.T)``'s device
   times at N = 262144 (from a profiler trace) beside the card's bound for
   the same work;
4. rescore kernel vs plain: the cell-rescore kernel against its plain
   version over the ragged cells of one 262,144-row shard (pad rows
   poisoned, so a read of one shows), at Q in {1, 16, 256}, c in
   {1, 8, 16}, k in {1, 5}, plus -1 probes (c > K), k past the probed
   rows, empty cells, D = 36 and 260, a misaligned array and equal rows
   in two probed cells; then its and the plain version's device times at
   the serving shape (Q = 1, c = 8, k = 1) beside the bound;
5. exact main path: ``run_biometric`` on the card once per match dtype,
   over a 4-shard watchlist of the 10 pipeline subjects plus 1,048,576
   random unit distractors (512 MiB of fp32 templates), 30 frames with the
   live hot-swap; then ``run_fleet`` for 3 s of offered traffic;
6. ANN main path: one such watchlist, indexed once (1024 cells), served by
   ``run_biometric(match_mode="ann", nprobe=8)`` once per match dtype; the
   served labels are held against the plain versions run on the kernels'
   own probe tables.
Each run of a main path sets the kernels' launch counts to 0 just before
it and reads them just after.

The last two lines before the final one are the card's name and power
limit and a JSON object with each kernel's numbers; the final line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
TOL = 1e-5              # kernel vs plain, max abs score error (see phase 3)
HBM_BYTES_S = 3.35e12   # H100 SXM device memory rate
PEAK_OPS_S = {          # H100 SXM dense peaks for the multiply-adds' type
    "fp32": 67e12,      # fp32 query x fp32 gallery: CUDA cores, no TF32
    "bf16": 989e12,     # bf16 x bf16 with fp32 accumulation: tensor cores
    "int8": 67e12,      # fp32 query x int8 gallery: an fp32 product
}
N_BIG = 262_144
DISTRACTORS = 1_048_576
SHARDS = 4
DTYPES = ("fp32", "bf16", "int8")
CELLS = 1024            # cells of one N_BIG shard at the index's sqrt(N)
NPROBE = 8              # the serving path's probes per query
DEV = "cuda"


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    return 1


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0]


def gallery(torch, gm, dtype, N, D, gen):
    """A unit-row gallery in the storage dtype: (g, scale or None)."""
    g = torch.randn((N, D), generator=gen, device=DEV)
    g = g / torch.linalg.vector_norm(g, dim=-1, keepdim=True)
    if dtype == "int8":
        return gm.quantize_gallery(g)
    return (g.to(torch.bfloat16) if dtype == "bf16" else g), None


def run_kernel(gm, q, g, scale, k):
    if scale is not None:
        return gm.gallery_match_quant_cuda(q, g, scale, k=k, fuse_norm=True)
    return gm.gallery_match_cuda(q, g, k=k, fuse_norm=True)


def run_plain(torch, gm, q, g, scale, k):
    k_eff = min(k, g.shape[0])
    qc = q.to(torch.bfloat16) if g.dtype == torch.bfloat16 else q
    return gm.gallery_match_plain(qc, g, scale, k=k_eff, fuse_norm=True)


def run_library(torch, q, g, k):
    """One PyTorch top-k over the full score matrix (fp32 and bf16)."""
    qn = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return torch.topk(qn.to(g.dtype) @ g.T, k, dim=1)


def compare(torch, gm, dtype, Q, N, k, gen, D=128, misalign=False):
    """Kernel vs plain on one shape; returns the max abs score error.
    ``misalign`` starts the gallery one element past a 16-byte boundary,
    which sends the kernel down its element-wise load path."""
    q = torch.randn((Q, D), generator=gen, device=DEV) * 3.0
    g, scale = gallery(torch, gm, dtype, N + misalign, D, gen)
    if misalign:
        g = g.reshape(-1)[1:1 + N * D].view(N, D)
        scale = scale[:N] if scale is not None else None
    s, i = run_kernel(gm, q, g, scale, k)
    torch.cuda.synchronize()
    ps, pi = run_plain(torch, gm, q, g, scale, k)
    k_eff = min(k, N)
    if tuple(s.shape) != (Q, k) or tuple(i.shape) != (Q, k):
        raise AssertionError(f"{dtype} Q={Q} N={N} k={k}: shape {s.shape}")
    if k_eff < k and not (bool((s[:, k_eff:] == gm.NEG).all())
                          and bool((i[:, k_eff:] == -1).all())):
        raise AssertionError(f"{dtype} Q={Q} N={N} k={k}: bad sentinels")
    s, i = s[:, :k_eff], i[:, :k_eff]
    err = float((s - ps).abs().max())
    if not err <= TOL:
        raise AssertionError(f"{dtype} Q={Q} N={N} k={k}: score error {err}")
    # an index may differ only for a row the plain version scores within
    # TOL of its own pick (a tie within the tolerance)
    qc = q.to(torch.bfloat16) if dtype == "bf16" else q
    qf = qc.float()
    qf = qf * torch.rsqrt(torch.clamp((qf * qf).sum(-1, keepdim=True),
                                      min=1e-18))
    picked = (qf[:, None, :] * g[i.long()].float()).sum(-1)
    if scale is not None:
        picked = picked * scale[i.long()]
    bad = (i != pi) & ((picked - ps).abs() > TOL)
    if bool(bad.any()):
        raise AssertionError(f"{dtype} Q={Q} N={N} k={k}: index mismatch")
    return err


def _kernel_us(prof) -> float:
    """Total device time of the kernels in a profile, in microseconds."""
    from torch.autograd import DeviceType
    total = 0.0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            total += getattr(e, "self_device_time_total", None) or \
                getattr(e, "self_cuda_time_total", 0.0)
    return total


def timed(torch, fn, galleries, iters=10):
    """(device ms, call ms) of one call of ``fn(*args)``, ``args`` taken in
    turn from ``galleries``.

    The gallery-match calls rotate over four galleries of one shard's size,
    as the serving path's four shards do, so no call finds its gallery in
    the 50 MB L2 cache.  Device ms is the kernels' own time, summed from a
    ``torch.profiler`` trace; call ms is CUDA events around back-to-back
    calls, so it also holds any time the card waits on the host."""
    from torch.profiler import ProfilerActivity, profile

    def rounds(n):
        for _ in range(n):
            for args in galleries:
                fn(*args)

    rounds(2)
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    rounds(iters)
    e1.record()
    e1.synchronize()
    n = iters * len(galleries)
    call_ms = e0.elapsed_time(e1) / n
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        rounds(iters)
        torch.cuda.synchronize()
    dev_us = _kernel_us(prof)
    if dev_us <= 0.0:
        raise AssertionError("the profiler saw no device time")
    return dev_us / n / 1e3, call_ms


def bound(dtype, Q, N, D, k):
    """The least time the card could take (ms), and what bounds it."""
    item = {"fp32": 4, "bf16": 2, "int8": 1}[dtype]
    q_item = 2 if dtype == "bf16" else 4
    nbytes = Q * D * q_item + N * D * item + Q * k * 8
    if dtype == "int8":
        nbytes += N * 4                          # per-row scales
    return work_bound(dtype, nbytes, 2.0 * Q * N * D)


def phase_build(modules):
    """Build every kernel library at once, one nvcc each, and print each
    build time and ptxas's report."""
    def one(mod):
        t0 = time.perf_counter()
        lib = mod.build(verbose=True)
        return lib, time.perf_counter() - t0

    with ThreadPoolExecutor(len(modules)) as pool:
        built = list(pool.map(one, modules))
    for lib, secs in built:
        print(f"[build] {lib.relative_to(ROOT)} in {secs:.1f} s")


def phase_kernel(torch, gm):
    gen = torch.Generator(device=DEV).manual_seed(1234)
    shapes = [(Q, N, k, 128, False) for Q in (1, 16, 256)
              for N in (1000, N_BIG) for k in (1, 5)]
    shapes += [(3, 3, 5, 128, False), (5, 1, 2, 128, False),  # k > N, Q < 8
               # the element-wise load path: long rows, odd rows, unaligned
               (5, 1000, 5, 260, False), (3, 777, 3, 36, False),
               (33, 999, 4, 128, True)]
    errs = {}
    for dtype in DTYPES:
        errs[dtype] = max(compare(torch, gm, dtype, Q, N, k, gen, D, mis)
                          for Q, N, k, D, mis in shapes)
        print(f"[kernel] {dtype}: kernel == plain on {len(shapes)} shapes, max abs "
              f"score error {errs[dtype]:.3g} (tolerance {TOL})")
    timings = {}
    D = 128
    for dtype in DTYPES:
        shards = [gallery(torch, gm, dtype, N_BIG, D, gen) for _ in range(4)]
        for Q in (1, 16, 256):
            for k in (1, 5):
                q = torch.randn((Q, D), generator=gen, device=DEV)
                kms, kcall = timed(torch, lambda g, sc: run_kernel(
                    gm, q, g, sc, k), shards)
                pms, _ = timed(torch, lambda g, sc: run_plain(
                    torch, gm, q, g, sc, k), shards)
                lms = None
                if dtype != "int8":
                    lms, _ = timed(torch, lambda g, sc: run_library(
                        torch, q, g, k), shards)
                bms, by = bound(dtype, Q, N_BIG, D, k)
                timings[(dtype, Q, k)] = (kms, pms, lms, bms, by)
                lib = f"{lms:.4f}" if lms is not None else "n/a"
                print(f"[kernel] {dtype} Q={Q:3d} N={N_BIG} D={D} k={k}: "
                      f"kernel_ms={kms:.4f} (per call {kcall:.4f}) "
                      f"plain_ms={pms:.4f} library_ms={lib} "
                      f"bound_ms={bms:.4f} ({by})")
        del shards
    return errs, timings


def shard_cells(torch, gm, dtype, K, D, gen, mean_len=256, misalign=False):
    """One shard's packed cells in the storage dtype: (cells, scale or
    None, lens, L).  Lengths are ragged around ``mean_len`` with every 97th
    cell empty; pad rows are poisoned (NaN, or int8 rows with a 1e30
    scale), so a kernel that scored one would be caught.  ``misalign``
    starts the array one element past a 16-byte boundary."""
    lens = (mean_len + 0.15 * mean_len * torch.randn(
        K, generator=gen, device=DEV)).round().clamp(min=0).int()
    lens[::97] = 0
    L = max(8, -(-int(lens.max()) // 8) * 8)
    rows = torch.randn((K * L, D), generator=gen, device=DEV)
    rows = rows / torch.linalg.vector_norm(rows, dim=-1, keepdim=True)
    pad = torch.arange(K * L, device=DEV) % L >= lens.repeat_interleave(L)
    scale = None
    if dtype == "int8":
        rows, scale = gm.quantize_gallery(rows)
        rows[pad], scale[pad] = 127, 1e30
    else:
        rows[pad] = float("nan")
        rows = rows.to(torch.bfloat16) if dtype == "bf16" else rows
    if misalign:
        buf = rows.new_empty(K * L * D + 1)
        rows = buf[1:].view(K * L, D).copy_(rows)
    return rows, scale, lens, L


def probe_table(torch, Q, c, K, gen):
    """c distinct random cells per query (-1 past the K-th, as the coarse
    scan pads when c > K)."""
    ids = torch.rand((Q, K), generator=gen, device=DEV).argsort(dim=1)
    ids = ids[:, :c].int()
    if c > K:
        ids = torch.cat([ids, ids.new_full((Q, c - K), -1)], 1)
    return ids.contiguous()


def compare_rescore(torch, A, q, cells, scale, ids, lens, L, k, strict=False):
    """Rescore kernel vs plain on one input; returns the max abs score
    error.  A position may differ from the plain version's only where the
    plain version scores the kernel's pick within TOL of its own, and must
    be a valid row of a probed cell; ``strict`` asks for equal positions
    (inputs with exact ties)."""
    Q = q.shape[0]
    s, p = A.cell_rescore_cuda(q, cells, ids, lens, scale, k=k, L=L)
    torch.cuda.synchronize()
    qc = q.to(torch.bfloat16) if cells.dtype == torch.bfloat16 else q
    ps, pp = A.cell_rescore_plain(qc, cells, ids, lens, scale, k=k, L=L,
                                  fuse_norm=True)
    what = f"{cells.dtype} Q={Q} c={ids.shape[1]} k={k} L={L}"
    if tuple(s.shape) != (Q, k) or tuple(p.shape) != (Q, k):
        raise AssertionError(f"{what}: shape {tuple(s.shape)}")
    if not torch.equal(p < 0, pp < 0) or not bool((s[p < 0] == A.NEG).all()):
        raise AssertionError(f"{what}: filled slots differ from the plain "
                             "version's")
    err = float((s - ps).abs().max())
    if not err <= TOL:
        raise AssertionError(f"{what}: score error {err}")
    live = p >= 0
    cell, row = (p // L).long(), (p % L).long()
    probed = (ids.long()[:, :, None] == cell[:, None, :]).any(dim=1)
    valid = probed & (row < lens.long()[cell.clamp(min=0)])
    if not bool(valid[live].all()):
        raise AssertionError(f"{what}: the kernel picked a pad row or a row "
                             "of a cell it did not probe")
    qf = qc.float()
    qf = qf * torch.rsqrt(torch.clamp((qf * qf).sum(-1, keepdim=True),
                                      min=1e-18))
    pl = p.long().clamp(min=0)
    picked = (qf[:, None, :] * cells[pl].float()).sum(-1)
    if scale is not None:
        picked = picked * scale[pl]
    bad = live & (p != pp) & ((picked - ps).abs() > TOL)
    if bool(bad.any()) or (strict and not torch.equal(p, pp)):
        raise AssertionError(f"{what}: position mismatch")
    return err


def rescore_work(dtype, Q, ids, lens, D, k):
    """(bytes, operations) one rescore needs: the valid rows of the
    distinct probed cells read once (with int8 scales), plus the query,
    the probe table, the probed cells' lengths and the output; and the
    multiply-adds of the dots the probes ask for."""
    item = {"fp32": 4, "bf16": 2, "int8": 1}[dtype]
    ids = ids.long()
    cells = ids[ids >= 0].unique()
    rows = int(lens.long()[cells].sum())
    nbytes = (rows * D * item + (rows * 4 if dtype == "int8" else 0)
              + Q * D * (2 if dtype == "bf16" else 4)
              + int(ids.ge(0).sum()) * 4 + len(cells) * 4 + Q * k * 8)
    scored = int((lens.long()[ids.clamp(min=0)] * ids.ge(0)).sum())
    return nbytes, 2.0 * scored * D


def work_bound(dtype, nbytes, ops):
    """The least time (ms) the card could take for ``nbytes`` and ``ops``
    of ``dtype`` work, and which of the two bounds it."""
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = ops / PEAK_OPS_S[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def run_rescore(A, q, cells, scale, ids, lens, L, k):
    return A.cell_rescore_cuda(q, cells, ids, lens, scale, k=k, L=L)


def run_rescore_plain(torch, A, q, cells, scale, ids, lens, L, k):
    qc = q.to(torch.bfloat16) if cells.dtype == torch.bfloat16 else q
    return A.cell_rescore_plain(qc, cells, ids, lens, scale, k=k, L=L,
                                fuse_norm=True)


def tie_cells(torch, gm, dtype, gen, D=128):
    """Cells 9 and 4 both hold the same 5 rows, and cell 4 holds its row 0
    again at row 6: a query equal to one of them ties exactly across two
    probed cells and inside one."""
    cells, scale, lens, L = shard_cells(torch, gm, "fp32", 12, D, gen,
                                        mean_len=10)
    lens[4], lens[9] = 8, 7
    cells[4 * L:4 * L + 8] = torch.nan_to_num(cells[4 * L:4 * L + 8])
    cells[9 * L:9 * L + 7] = torch.nan_to_num(cells[9 * L:9 * L + 7])
    cells[9 * L:9 * L + 5] = cells[4 * L:4 * L + 5]
    cells[4 * L + 6] = cells[4 * L]
    q = torch.stack([cells[4 * L], cells[4 * L + 2], cells[4 * L + 6]]) * 2
    ids = torch.tensor([[9, 4, 0], [4, 9, 1], [0, 9, 4]], dtype=torch.int32,
                       device=DEV)
    if dtype == "int8":
        cells, scale = gm.quantize_gallery(torch.nan_to_num(cells))
    elif dtype == "bf16":
        cells = cells.to(torch.bfloat16)
    return q, cells, scale, ids, lens, L


def phase_rescore(torch, gm, A):
    gen = torch.Generator(device=DEV).manual_seed(4321)
    D = 128
    errs, timings = {}, {}
    for dtype in DTYPES:
        err, n = 0.0, 0

        def check(*args, **kw):
            nonlocal err, n
            err = max(err, compare_rescore(torch, A, *args, **kw))
            n += 1

        cells, scale, lens, L = shard_cells(torch, gm, dtype, CELLS, D, gen)
        for Q in (1, 16, 256):
            for c in (1, NPROBE, 16):
                ids = probe_table(torch, Q, c, CELLS, gen)
                ids[::3, 0] = 0             # cell 0 is empty: probe it too
                q = torch.randn((Q, D), generator=gen, device=DEV) * 3.0
                for k in (1, 5):
                    check(q, cells, scale, ids, lens, L, k)
        # -1 probes (c > K), k past the probed rows, D = 36 and 260 (the
        # element-wise load path), a misaligned array
        for K, Dx, c, k, mean, mis in ((5, D, 8, 5, 40, False),
                                       (16, D, 2, 40, 2, False),
                                       (40, 36, 4, 5, 30, False),
                                       (40, 260, 4, 5, 30, False),
                                       (40, D, 4, 5, 30, True)):
            xc, xs, xl, xL = shard_cells(torch, gm, dtype, K, Dx, gen,
                                         mean_len=mean, misalign=mis)
            ids = probe_table(torch, 6, c, K, gen)
            ids[-1] = -1                    # a query with no valid probe
            q = torch.randn((6, Dx), generator=gen, device=DEV)
            check(q, xc, xs, ids, xl, xL, k)
        check(*tie_cells(torch, gm, dtype, gen), 6, strict=True)
        errs[dtype] = err
        print(f"[rescore] {dtype}: kernel == plain on {n} inputs, max abs "
              f"score error {err:.3g} (tolerance {TOL})")
        # the serving shape; four shards' cells and 16 probe tables each,
        # so one round reads more distinct rows than the L2 cache holds
        shards = [(cells, scale, lens, L)] + [
            shard_cells(torch, gm, dtype, CELLS, D, gen) for _ in range(3)]
        q = torch.randn((1, D), generator=gen, device=DEV)
        calls = [(q, sc[0], sc[1], probe_table(torch, 1, NPROBE, CELLS, gen),
                  sc[2], sc[3], 1) for sc in shards for _ in range(16)]
        kms, kcall = timed(torch, lambda *a: run_rescore(A, *a), calls)
        pms, _ = timed(torch, lambda *a: run_rescore_plain(torch, A, *a),
                       calls)
        work = [rescore_work(dtype, 1, a[3], a[4], D, 1) for a in calls]
        bms, by = work_bound(dtype, sum(w[0] for w in work) / len(work),
                             sum(w[1] for w in work) / len(work))
        timings[dtype] = (kms, pms, bms, by)
        print(f"[rescore] {dtype} Q=1 c={NPROBE} k=1 L={L} D={D}: "
              f"kernel_ms={kms:.4f} (per call {kcall:.4f}) plain_ms={pms:.4f}"
              f" library_ms=n/a bound_ms={bms:.6f} ({by})")
        del shards, calls
    return errs, timings


class Recorder:
    """Wraps ``WatchlistCartridge.process_batch`` to keep what each frame
    matched: (seq, label, score, query embedding)."""

    def __init__(self, cls):
        self.cls, self.orig = cls, cls.process_batch
        self.rows, self.gallery, self.cart = [], None, None

    def __enter__(self):
        rec = self

        def process_batch(cart, ms):
            rec.gallery, rec.cart = cart.gallery, cart
            out = rec.orig(cart, ms)
            for m_in, m_out in zip(ms, out):
                if m_in.payload is not None:
                    rec.rows.append((m_in.seq, m_out.payload["label"],
                                     m_out.payload["score"],
                                     m_in.payload.detach().clone()))
            return out

        self.cls.process_batch = process_batch
        return self

    def __exit__(self, *exc):
        self.cls.process_batch = self.orig


def plain_labels(torch, gm, gallery, emb, dtype):
    """Top-1 labels of ``emb`` by the plain version over the gallery's
    prepared shard views on the card, merged as ``match`` merges."""
    q = gallery.rotation.protect(emb)
    best = None
    for s in range(gallery.n_shards):
        if not len(gallery._shard_ids[s]):
            continue
        prep = gallery._prepare(s, dtype)
        if dtype == "int8":
            g, scale = prep["q8"], prep["scale"]
        else:
            g, scale = prep["gn_bf16" if dtype == "bf16" else "gn"], None
        ps, pi = run_plain(torch, gm, q, g, scale, 1)
        gid = torch.as_tensor(gallery._shard_ids[s], device=DEV)[pi[:, 0]]
        cand = (ps[:, 0], gid)
        if best is None:
            best = cand
        else:
            take = (cand[0] > best[0]) | ((cand[0] == best[0])
                                          & (cand[1] < best[1]))
            best = (torch.where(take, cand[0], best[0]),
                    torch.where(take, cand[1], best[1]))
    labels = [gallery._labels[int(g)] for g in best[1].cpu()]
    return labels, best[0].cpu()


def phase_main(torch, gm, serve):
    launches = {}
    for dtype in DTYPES:
        t0 = time.perf_counter()
        with Recorder(serve.WatchlistCartridge) as rec:
            gm.launches = 0
            rep = serve.run_biometric(
                n_frames=30, hotswap=True, device=DEV, n_shards=SHARDS,
                match_dtype=dtype, distractors=DISTRACTORS)
            launches[dtype] = gm.launches
        wall = time.perf_counter() - t0
        rows = sorted(rec.rows, key=lambda r: r[0])
        if rep.frames_out != 30 or rep.lost != 0:
            raise AssertionError(f"{dtype}: frames_out={rep.frames_out} "
                                 f"lost={rep.lost}")
        if launches[dtype] <= 0:
            raise AssertionError(f"{dtype}: the kernel never launched")
        if [r[0] for r in rows] != list(range(30)):
            raise AssertionError(f"{dtype}: matched seqs {[r[0] for r in rows]}")
        want = [f"subject{seq % 10}" for seq, *_ in rows]
        got = [r[1] for r in rows]
        wrong = sum(a != b for a, b in zip(got, want))
        plain, plain_s = plain_labels(torch, gm, rec.gallery,
                                      torch.stack([r[3] for r in rows]),
                                      dtype)
        serr = float((torch.tensor([r[2] for r in rows]) - plain_s)
                     .abs().max())
        if got != plain or not serr <= TOL:
            raise AssertionError(f"{dtype}: kernel labels {got} differ from "
                                 f"the plain version's {plain} (score "
                                 f"error {serr})")
        if dtype != "int8" and wrong:
            raise AssertionError(f"{dtype}: {wrong} frames matched the wrong "
                                 f"subject: {got}")
        print(f"[main] {dtype}: {len(rec.gallery)} templates in "
              f"{rec.gallery.n_shards} shards, frames_out={rep.frames_out} "
              f"lost={rep.lost} launches={launches[dtype]} "
              f"labels==subject {30 - wrong}/30, labels==plain 30/30, "
              f"wall_s={wall:.1f}")
    gm.launches = 0
    t0 = time.perf_counter()
    rep = serve.run_fleet(duration_s=3.0, device=DEV)
    fleet_launches = gm.launches
    launches["fp32"] += fleet_launches
    if rep.lost != 0 or fleet_launches <= 0:
        raise AssertionError(f"fleet: lost={rep.lost} "
                             f"launches={fleet_launches}")
    for name, row in rep.frontdoor["tenants"].items():
        if row["offered"] != row["admitted"] + row["shed"] + row["queued"]:
            raise AssertionError(f"fleet: conservation broken for {name}: "
                                 f"{row}")
    print(f"[main] fleet: frames_out={rep.frames_out}/{rep.frames_in} "
          f"lost={rep.lost} launches={fleet_launches} conservation holds "
          f"for {len(rep.frontdoor['tenants'])} tenants, "
          f"wall_s={time.perf_counter() - t0:.1f}")
    return launches


class ProbeRecorder:
    """Keeps the probe table of each ``_coarse_scan`` of one gallery, in
    call order (one call per ``match``)."""

    def __init__(self, gallery):
        self.gallery, self.ids = gallery, []

    def __enter__(self):
        orig = self.gallery._coarse_scan

        def coarse_scan(q, nprobe, dtype):
            out = orig(q, nprobe, dtype)
            self.ids.append((q.clone(), out[1].clone()))
            return out

        self.gallery._coarse_scan = coarse_scan
        return self

    def __exit__(self, *exc):
        del self.gallery._coarse_scan


def plain_ann(torch, gm, A, gallery, q, ids, dtype):
    """Top-1 (labels, scores) of protected queries ``q`` by the rescore's
    plain version over the gallery's packed shard views on the card, on the
    probe table ``ids``, merged as ``match`` merges; and the coarse scan's
    plain probe table check (each kernel pick equal to the plain version's,
    or scored by it within TOL of its own pick)."""
    cb = gallery._ann_dev[dtype]
    cents, cscale = cb[0], (cb[1] if dtype == "int8" else None)
    ps, pi = run_plain(torch, gm, q, cents, cscale, ids.shape[1])
    qc = q.to(torch.bfloat16) if dtype == "bf16" else q
    qf = qc.float()
    qf = qf * torch.rsqrt(torch.clamp((qf * qf).sum(-1, keepdim=True),
                                      min=1e-18))
    picked = (qf[:, None, :] * cents[ids.long()].float()).sum(-1)
    if cscale is not None:
        picked = picked * cscale[ids.long()]
    if bool(((ids != pi) & ((picked - ps).abs() > TOL)).any()):
        raise AssertionError(f"{dtype}: the coarse scan's probe table "
                             "differs from the plain version's")
    best = None
    for s in range(gallery.n_shards):
        if not len(gallery._shard_ids[s]):
            continue
        ann = gallery._prepare_ann(s, dtype)
        layout = ann["layout"]
        if dtype == "int8":
            cells, scale = ann["q8"], ann["scale"]
        else:
            cells = ann["packed_bf16" if dtype == "bf16" else "packed"]
            scale = None
        rs, rp = A.cell_rescore_plain(qc, cells, ids, ann["lens"], scale,
                                      k=1, L=layout.L, fuse_norm=True)
        rows = torch.as_tensor(layout.pos_to_row, device=DEV)[
            rp[:, 0].long().clamp(min=0)]
        gid = torch.as_tensor(gallery._shard_ids[s], device=DEV)[rows]
        gid = torch.where(rp[:, 0] >= 0, gid, torch.full_like(gid, 2**62))
        cand = (rs[:, 0], gid)
        if best is None:
            best = cand
        else:
            take = (cand[0] > best[0]) | ((cand[0] == best[0])
                                          & (cand[1] < best[1]))
            best = (torch.where(take, cand[0], best[0]),
                    torch.where(take, cand[1], best[1]))
    labels = [gallery._labels[int(g)] if int(g) < 2**62 else None
              for g in best[1].cpu()]
    return labels, best[0].cpu()


def phase_ann(torch, gm, A, serve):
    """The ANN main path: one 1,048,586-template watchlist in 4 shards,
    enrolled and indexed by the first run, served once per match dtype."""
    from repro_torch.crypto import SecureGallery
    gallery = SecureGallery(serve.EMB_DIM, seed=7, n_shards=SHARDS,
                            device=DEV)
    build_s = []
    train = gallery.build_ann_index

    def build_ann_index(**kw):
        t0 = time.perf_counter()
        train(**kw)
        torch.cuda.synchronize()
        build_s.append(time.perf_counter() - t0)

    gallery.build_ann_index = build_ann_index
    launches, fractions = {}, {}
    for dtype in DTYPES:
        gallery.match_dtype = dtype
        t0 = time.perf_counter()
        with Recorder(serve.WatchlistCartridge) as rec, \
                ProbeRecorder(gallery) as probes:
            gm.launches = A.launches = 0
            rep = serve.run_biometric(
                n_frames=30, hotswap=True, device=DEV, n_shards=SHARDS,
                distractors=DISTRACTORS, match_mode="ann", nprobe=NPROBE,
                gallery=gallery)
            launches[dtype] = (gm.launches, A.launches)
        wall = time.perf_counter() - t0
        if dtype == DTYPES[0]:
            print(f"[ann] index: {gallery._ann_n_cells} cells over "
                  f"{len(gallery)} templates, trained in {build_s[0]:.1f} s")
        calls = rec.cart.stats["match_calls"]
        n_gm, n_cr = launches[dtype]
        if rep.frames_out != 30 or rep.lost != 0:
            raise AssertionError(f"ann {dtype}: frames_out={rep.frames_out} "
                                 f"lost={rep.lost}")
        if len(build_s) != 1 or calls != len(probes.ids) or \
                n_gm != calls or n_cr != SHARDS * calls or calls == 0:
            raise AssertionError(
                f"ann {dtype}: {calls} match calls, {len(probes.ids)} coarse "
                f"scans, launches coarse={n_gm} rescore={n_cr}, "
                f"{len(build_s)} index builds")
        # the served labels vs the plain versions on the kernels' own probe
        # tables (rows recorded in the order the calls matched them)
        q = torch.cat([p[0] for p in probes.ids])
        ids = torch.cat([p[1] for p in probes.ids])
        plain, plain_s = plain_ann(torch, gm, A, gallery, q, ids, dtype)
        got = [r[1] for r in rec.rows]
        serr = float((torch.tensor([r[2] for r in rec.rows]) - plain_s)
                     .abs().max())
        if got != plain or not serr <= TOL:
            raise AssertionError(f"ann {dtype}: kernel labels {got} differ "
                                 f"from the plain version's {plain} (score "
                                 f"error {serr})")
        right = sum(lab == f"subject{seq % 10}" for seq, lab, *_ in rec.rows)
        fractions[dtype] = gallery.last_match_stats["scan_fraction"]
        print(f"[ann] {dtype}: {len(gallery)} templates in {SHARDS} shards, "
              f"nprobe={NPROBE}, frames_out={rep.frames_out} lost={rep.lost}"
              f" match_calls={calls} launches gallery_match={n_gm} "
              f"cell_rescore={n_cr}, labels==subject {right}/30, "
              f"labels==plain 30/30, scan_fraction="
              f"{fractions[dtype]:.6f}, wall_s={wall:.1f}")
    return launches, fractions


def phase_reference(torch, serve):
    """The serving stages on the card vs on the CPU (which the tests hold
    against the JAX reference), on 10 frames, with TF32 off."""
    from repro_torch.data import FrameStream
    src = FrameStream(seed=3)
    embs = []
    for dev in ("cuda", "cpu"):
        reg, _ = serve.build_biometric_pipeline(device=dev)
        embs.append(serve._pipeline_embed(reg, src, range(10)).cpu())
    err = float((embs[0] - embs[1]).abs().max())
    if not (torch.isfinite(embs[0]).all() and err <= TOL
            and tuple(embs[0].shape) == (10, serve.EMB_DIM)):
        raise AssertionError(f"embeddings on the card differ from the "
                             f"CPU's by {err}")
    print(f"[check] 10 embeddings on the card vs the CPU: max abs error "
          f"{err:.3g} (tolerance {TOL})")


def main() -> int:
    try:
        import torch
    except ImportError:
        return fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        return fail("no CUDA device")
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        return fail(f"the port's sources are not under {SRC}")
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import ann_match as A
    from repro_torch.kernels import gallery_match as gm
    from repro_torch.launch import serve

    card = card_line()
    print(f"[card] {card}")
    phase_build([gm, A])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    errs, timings = phase_kernel(torch, gm)
    r_errs, r_timings = phase_rescore(torch, gm, A)
    phase_reference(torch, serve)
    launches = phase_main(torch, gm, serve)
    ann_launches, _ = phase_ann(torch, gm, A, serve)

    kernels = []
    for dtype in DTYPES:
        kms, pms, lms, bms, by = timings[(dtype, 1, 1)]
        kernels.append({
            "name": f"gallery_match[{dtype}]", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/gallery_match.cu",
            "replaces": "src/repro/kernels/gallery_match.py:136",
            "launches": launches[dtype] + ann_launches[dtype][0],
            "max_abs_err": errs[dtype],
            "ms": kms, "plain_ms": pms, "bound_ms": bms, "bound_by": by,
            "library_ms": lms, "shape": f"Q=1 N={N_BIG} D=128 k=1"})
    for dtype in DTYPES:
        kms, pms, bms, by = r_timings[dtype]
        kernels.append({
            "name": f"cell_rescore[{dtype}]", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/cell_rescore.cu",
            "replaces": "src/repro/kernels/ann_match.py:200",
            "launches": ann_launches[dtype][1], "max_abs_err": r_errs[dtype],
            "ms": kms, "plain_ms": pms, "bound_ms": bms, "bound_by": by,
            "library_ms": None,
            "shape": f"Q=1 c={NPROBE} K={CELLS} D=128 k=1"})
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
