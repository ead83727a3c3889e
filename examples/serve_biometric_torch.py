"""Field-biometrics scenario (paper §5) on the port: checkpoint watchlist
screening.

1. enroll 10 subjects into the encrypted gallery (templates protected by
   the keyed rotation, stored under the Threefry stream cipher);
2. stream camera frames through detect -> quality -> embed -> match;
3. mid-mission, the operator pulls the quality cartridge (hot-swap) —
   screening continues with zero frame loss;
4. re-keying the gallery (revocation) keeps matching working;
5. a forensic 1:N search asks for a ranked list of 100 candidates over an
   enrolled watchlist.

The port of ``examples/serve_biometric.py`` onto ``repro_torch``, with its
assertions, plus step 5 (k = 100 runs two rounds of the match kernel on
the card), on the card unless ``--device cpu``.

Run:  PYTHONPATH=src python examples/serve_biometric_torch.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.launch.serve import build_biometric_pipeline, run_biometric

WATCHLIST = 20_000      # templates the ranked search runs over
RANKED_K = 100          # candidates it asks for


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="where the pipeline runs (default: the card)")
    args = ap.parse_args(argv)
    rep = run_biometric(n_frames=30, hotswap=True, device=args.device)
    assert rep.lost == 0
    assert rep.total_downtime() < 1.0  # only the 0.5 s removal pause

    # revocation demo
    reg, gallery = build_biometric_pipeline(seed=1, device=args.device)
    rng = np.random.default_rng(0)
    raw = rng.normal(size=(5, 128)).astype(np.float32)
    gallery.enroll(raw, [f"s{i}" for i in range(5)])
    labels_before, _ = gallery.match(raw[[2]], k=1)
    gallery.rekey(new_seed=99)
    labels_after, _ = gallery.match(raw[[2]], k=1)
    assert labels_before[0, 0] == labels_after[0, 0] == "s2"

    # a ranked candidate list: a noisy probe of watchlist row 1234
    watch = rng.normal(size=(WATCHLIST, 128)).astype(np.float32)
    gallery.enroll(watch, [f"w{i}" for i in range(WATCHLIST)])
    probe = watch[[1234]] + 0.3 * rng.normal(size=(1, 128)).astype(np.float32)
    labels, scores = gallery.match(probe, k=RANKED_K)
    s = scores[0].numpy()
    assert labels.shape == (1, RANKED_K) and labels[0, 0] == "w1234"
    assert len(set(labels[0])) == RANKED_K and bool((s[:-1] >= s[1:]).all())
    print(f"ranked search: {RANKED_K} candidates over {len(gallery)} "
          f"templates, first {labels[0, 0]} ({s[0]:.4f}), last "
          f"{labels[0, -1]} ({s[-1]:.4f})")
    print("serve_biometric OK — zero-loss hot-swap + revocable templates")


if __name__ == "__main__":
    main()
