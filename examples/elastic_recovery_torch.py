"""Elastic-training demo on the port (1000-node behaviour at laptop
scale): a node failure mid-run triggers checkpoint restore and a
deterministic replay of the data stream, and the final loss matches an
uninterrupted run's.

The port of ``examples/elastic_recovery.py`` onto ``repro_torch``'s
``launch.train.main`` (the smoke tinyllama, on the card unless
``--device cpu``): one clean run, one that fails at step 80 and recovers
from the step-80 checkpoint; their final losses must agree within 1e-3.
Checkpoints go to temporary directories, removed at the end.

Run:  PYTHONPATH=src python examples/elastic_recovery_torch.py [--device cpu]
"""
import argparse
import shutil
import tempfile

from repro_torch.device import resolve_device
from repro_torch.launch import train


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="where both runs train (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    args_common = ["--arch", "tinyllama-1.1b", "--smoke", "--steps", "120",
                   "--batch", "8", "--seq", "64", "--ckpt-every", "40",
                   "--lr", "1e-3", "--log-every", "40", "--device", str(dev)]
    dirs = [tempfile.mkdtemp(prefix="elastic_") for _ in range(2)]
    try:
        clean = train.main(args_common + ["--ckpt-dir", dirs[0]])
        recovered = train.main(args_common + [
            "--ckpt-dir", dirs[1], "--simulate-failure", "80"])
    finally:
        for d in dirs:
            shutil.rmtree(d, ignore_errors=True)

    print(f"clean final loss     {clean:.6f}")
    print(f"recovered final loss {recovered:.6f}")
    assert abs(clean - recovered) < 1e-3, \
        "deterministic replay must reproduce the clean run"
    print("elastic_recovery_torch OK — failure at step 80 recovered exactly")


if __name__ == "__main__":
    main()
