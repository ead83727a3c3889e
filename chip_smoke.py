#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing its lines; any failure exits non-zero:

1. card: the GPU's name and power limit, from nvidia-smi;
2. build: compile the CUDA gallery-match kernel from ``src/repro_torch/
   kernels/csrc`` (nvcc, sm_90a) and print the build time;
3. kernel vs plain: the kernel against its plain PyTorch version on the
   card, for fp32, bf16 and int8 galleries at Q in {1, 16, 256},
   N in {1000, 262144}, D = 128, k in {1, 5}, plus k > N and galleries
   that take the kernel's element-wise load path; then the
   kernel's, the plain version's and ``torch.topk(q @ g.T)``'s device
   times at N = 262144 (from a profiler trace) beside the card's bound for
   the same work;
4. main path: ``run_biometric`` on the card once per match dtype, over a
   4-shard watchlist of the 10 pipeline subjects plus 1,048,576 random
   unit distractors (512 MiB of fp32 templates), 30 frames with the live
   hot-swap; then ``run_fleet`` for 3 s of offered traffic.  The kernel's
   launch count is set to 0 before and read after each run.

The last two lines before the final one are the card's name and power
limit and a JSON object with each kernel's numbers; the final line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
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
    g = torch.randn((N, D), generator=gen, device="cuda")
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
    q = torch.randn((Q, D), generator=gen, device="cuda") * 3.0
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
    """(device ms, call ms) of one call of ``fn(g, scale)``.

    The calls rotate over four galleries of one shard's size, as the
    serving path's four shards do, so no call finds its gallery in the
    50 MB L2 cache.  Device ms is the kernels' own time, summed from a
    ``torch.profiler`` trace; call ms is CUDA events around back-to-back
    calls, so it also holds any time the card waits on the host."""
    from torch.profiler import ProfilerActivity, profile

    def rounds(n):
        for _ in range(n):
            for g, scale in galleries:
                fn(g, scale)

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
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = 2.0 * Q * N * D / PEAK_OPS_S[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_kernel(torch, gm):
    gen = torch.Generator(device="cuda").manual_seed(1234)
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
                q = torch.randn((Q, D), generator=gen, device="cuda")
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


class Recorder:
    """Wraps ``WatchlistCartridge.process_batch`` to keep what each frame
    matched: (seq, label, score, query embedding)."""

    def __init__(self, cls):
        self.cls, self.orig = cls, cls.process_batch
        self.rows, self.gallery = [], None

    def __enter__(self):
        rec = self

        def process_batch(cart, ms):
            rec.gallery = cart.gallery
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
        gid = torch.as_tensor(gallery._shard_ids[s], device="cuda")[pi[:, 0]]
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
                n_frames=30, hotswap=True, device="cuda", n_shards=SHARDS,
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
    rep = serve.run_fleet(duration_s=3.0, device="cuda")
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
    from repro_torch.kernels import gallery_match as gm
    from repro_torch.launch import serve

    card = card_line()
    print(f"[card] {card}")
    t0 = time.perf_counter()
    lib = gm.build(verbose=True)
    print(f"[build] {lib.relative_to(ROOT)} in "
          f"{time.perf_counter() - t0:.1f} s")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    errs, timings = phase_kernel(torch, gm)
    phase_reference(torch, serve)
    launches = phase_main(torch, gm, serve)

    kernels = []
    for dtype in DTYPES:
        kms, pms, lms, bms, by = timings[(dtype, 1, 1)]
        kernels.append({
            "name": f"gallery_match[{dtype}]", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/gallery_match.cu",
            "replaces": "src/repro/kernels/gallery_match.py:136",
            "launches": launches[dtype], "max_abs_err": errs[dtype],
            "ms": kms, "plain_ms": pms, "bound_ms": bms, "bound_by": by,
            "library_ms": lms, "shape": f"Q=1 N={N_BIG} D=128 k=1"})
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
