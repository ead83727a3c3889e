#!/usr/bin/env python3
"""Time this checkout's gallery-match kernel against another checkout's, on
one GPU, in one process.

    python3 kernel_compare.py OTHER_CHECKOUT [--shapes Q:k,...] [--qk N]

OTHER_CHECKOUT is another checkout of this repository, for example the
parent commit unpacked with ``git archive``.  Each kernel is built with
``nvcc`` from its own checkout's sources; both are then held against each
other on one input, and timed in turns (other, this, this, other) on the
same four 262,144-row galleries with ``chip_smoke.py``'s device timing
(profiler kernel time), at D = 128 and each (Q, k) of ``--shapes``
(default: Q in {1, Q_S, 16, 256} x k in {1, 5}), in each storage dtype.
``--qk N`` sets this checkout's small-Q path limit on Q * k for the run
(``gallery_match.SMALL_QK``), to time that path where ``plan`` would not
take it.  Prints the card, one line per shape, and a JSON object with
every time.  Exits non-zero without a GPU.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))


def load_other(other: Path, _build):
    """The other checkout's gallery-match wrapper, bound to its own kernel
    built into this checkout's build directory."""
    src = other / "src" / "repro_torch" / "kernels"
    spec = importlib.util.spec_from_file_location("other_gallery_match",
                                                  src / "gallery_match.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = _build.BUILD_DIR / "other_gallery_match.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                    str(src / "csrc" / "gallery_match.cu")], check=True)
    lib = ctypes.CDLL(str(so))
    own = _build.library
    _build.library = lambda name: lib    # its wrapper binds through ours
    try:
        mod._library()
    finally:
        _build.library = own
    return mod


def main() -> int:
    ap = argparse.ArgumentParser(usage=__doc__)
    ap.add_argument("other", type=Path)
    ap.add_argument("--shapes", default=None)
    ap.add_argument("--qk", type=int, default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("kernel_compare: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import gallery_match as gm
    if args.qk is not None:
        gm.SMALL_QK = args.qk
    shapes = ([tuple(int(x) for x in p.split(":"))
               for p in args.shapes.split(",")] if args.shapes else
              [(Q, k) for Q in (1, gm.SMALL_Q, 16, 256) for k in (1, 5)])

    card = cs.card_line()
    print(f"[card] {card}")
    with ThreadPoolExecutor(2) as pool:
        own = pool.submit(gm.build)
        other = pool.submit(load_other, args.other.resolve(), _build)
        own.result()
        ogm = other.result()
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(99)
    rows = []
    for dtype in cs.DTYPES:
        shards = [cs.gallery(torch, gm, dtype, cs.N_BIG, 128, gen)
                  for _ in range(4)]
        for Q, k in shapes:
            q = torch.randn((Q, 128), generator=gen, device="cuda")
            a = cs.run_kernel(ogm, q, *shards[0], k)
            b = cs.run_kernel(gm, q, *shards[0], k)
            err = float((a[0] - b[0]).abs().max())
            if not err <= cs.TOL:
                raise AssertionError(f"{dtype} Q={Q} k={k}: the two "
                                     f"kernels differ by {err}")
            times = {"other": [], "this": []}
            for name in ("other", "this", "this", "other"):
                mod = ogm if name == "other" else gm
                ms, _ = cs.timed(torch, lambda g, sc: cs.run_kernel(
                    mod, q, g, sc, k), shards)
                times[name].append(ms)
            o, t = (sum(v) / 2 for v in (times["other"], times["this"]))
            rows.append({"dtype": dtype, "Q": Q, "k": k,
                         "path": gm.last_plan[0], **times,
                         "this_over_other": t / o})
            print(f"[compare] {dtype} Q={Q:3d} k={k}: other "
                  f"{times['other'][0]:.4f} {times['other'][1]:.4f} ms, "
                  f"this {times['this'][0]:.4f} {times['this'][1]:.4f} ms "
                  f"({gm.last_plan[0]} path), this/other {t / o:.3f}")
        del shards
    print(card)
    print(json.dumps({"compare": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
