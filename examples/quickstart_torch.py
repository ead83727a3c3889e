"""Quickstart on the port: assemble a CHAMP pipeline like LEGO bricks,
stream frames through it, hot-swap a cartridge live, and match against an
encrypted watchlist.

The port of ``examples/quickstart.py`` onto ``repro_torch``: the same
``run_biometric`` call and assertion, on the card unless ``--device cpu``.

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse

from repro_torch.launch.serve import run_biometric


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="where the pipeline runs (default: the card)")
    args = ap.parse_args(argv)
    rep = run_biometric(n_frames=24, hotswap=True, device=args.device)
    assert rep.lost == 0, "hot-swap must not lose frames"
    print("quickstart OK — zero frame loss across a live hot-swap")


if __name__ == "__main__":
    main()
