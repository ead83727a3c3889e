"""End-to-end training example on the PyTorch port: a ~100M-param
TinyLlama-family model trained on the synthetic token stream, with
checkpointing and an optional simulated mid-run node failure + recovery.

The port's counterpart of ``examples/train_lm.py``: the same model and
flags through ``repro_torch.launch.train``.  On the card (the default) the
attention runs on the hand-written flash kernels, forward and backward;
``--device cpu`` runs the kernel's plain version and its gradient.

Run:  PYTHONPATH=src python examples/train_lm_torch.py [--steps 200]
          [--fail-at 120] [--device cpu]
"""
import argparse
import os
import shutil
import tempfile

import repro_torch.configs.tinyllama_1_1b as tl
from repro_torch.launch import train


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--fail-at", type=int, default=0,
                    help="simulate a node failure at this step")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args()

    ckpt = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt_example")
    shutil.rmtree(ckpt, ignore_errors=True)
    # ~100M params: TinyLlama family scaled (12L x 768d x 12H, 16k vocab)
    orig_smoke = tl.smoke
    tl.smoke = lambda: tl.CONFIG.replace(
        n_layers=12, d_model=768, n_heads=12, n_kv_heads=4, d_ff=2048,
        vocab_size=16384, remat=False)
    try:
        argv = ["--arch", "tinyllama-1.1b", "--smoke",
                "--steps", str(args.steps), "--batch", "8", "--seq", "128",
                "--ckpt-dir", ckpt, "--ckpt-every", "50", "--lr", "1e-3"]
        if args.fail_at:
            argv += ["--simulate-failure", str(args.fail_at)]
        if args.device:
            argv += ["--device", args.device]
        final = train.main(argv)
        if not final < 7.0:
            raise SystemExit(f"loss did not move: {final}")
        print(f"train_lm_torch OK — final loss {final:.3f}")
    finally:
        tl.smoke = orig_smoke
        shutil.rmtree(ckpt, ignore_errors=True)


if __name__ == "__main__":
    main()
