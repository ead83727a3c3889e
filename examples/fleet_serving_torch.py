"""Multi-tenant fleet serving through the front door, live, on the port.

Three tenant tiers share one 8-lane edge kit: ``field_ops`` (checkpoint
operators, priority 0, tight SLO), ``recon`` (priority 1), and
``backfill`` (archive re-identification, priority 2, bulk).  The demo
drives the fleet at 1x, 2x, and 4x its nominal capacity and shows the
front door's graceful-degradation contract:

1. At 1x, everyone rides free: goodput ~1.0 across the board.
2. At 4x, the door sheds almost all of backfill, some of recon, and
   none of field_ops — and field_ops p99 stays pinned at its unloaded
   value, inside the SLO.  Overload lands on the bulk tier, never on
   the operator holding a device at a checkpoint.
3. Total completed frames NEVER drop as overload grows: shedding at
   admission protects the pipeline from queue collapse.

The port of ``examples/fleet_serving.py`` onto ``repro_torch``: the same
sweep (virtual time) with the same assertions, then the biometric
pipeline itself behind the same front door (``run_fleet``: each tenant's
watchlist, real frames through detect, quality, embed and match), on the
card unless ``--device cpu``, with no frame lost and every tenant's
offered frames admitted, shed or queued.

Run:  PYTHONPATH=src python examples/fleet_serving_torch.py [--device cpu]
"""
import argparse

from repro_torch.launch.serve import run_fleet
from repro_torch.runtime import FLEET_TENANTS, run_fleet_sweep


def describe(overload, rep):
    fd = rep.frontdoor
    total = sum(t["completed"] for t in fd["tenants"].values())
    print(f"\noffered load {overload:g}x nominal "
          f"(completed {total}, shed {fd['shed']}, lost {rep.lost}):")
    for name, t in fd["tenants"].items():
        print(f"  {name:<10} [{t['class']:<11}] "
              f"goodput {t['goodput']:5.3f}  "
              f"p99 {t['latency']['p99'] * 1e3:7.1f} ms  "
              f"shed {t['shed']:5d}  slo_miss {t['slo_miss']}")
    return total


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="where the live pipeline runs (default: the card)")
    args = ap.parse_args(argv)
    tiers = {t.name: t for t in FLEET_TENANTS}
    print("fleet kit: 8 identical lanes behind the front door, tenant "
          "tiers " + ", ".join(f"{t.name}(p{t.priority}, w{t.weight:g})"
                               for t in FLEET_TENANTS))

    totals = {}
    reps = {}
    for overload in (1.0, 2.0, 4.0):
        rep = run_fleet_sweep(overload, duration_s=4.0)
        reps[overload] = rep
        totals[overload] = describe(overload, rep)
        assert rep.lost == 0, f"in-pipeline loss at {overload}x"

    # the graceful-degradation contract, asserted --------------------------
    peak = reps[4.0].frontdoor["tenants"]
    slo = tiers["field_ops"].slo_s
    assert peak["field_ops"]["goodput"] == 1.0, "interactive tier shed"
    assert peak["field_ops"]["latency"]["p99"] <= slo, \
        f"field_ops p99 {peak['field_ops']['latency']['p99']} > SLO {slo}"
    assert peak["backfill"]["shed"] > 0, "bulk never shed at 4x?"
    gp = [peak[n]["goodput"] for n in ("field_ops", "recon", "backfill")]
    assert gp == sorted(gp, reverse=True), f"shed order broke class order: {gp}"
    assert totals[4.0] >= 0.9 * totals[1.0], \
        f"throughput collapsed under overload: {totals}"

    print("\nall degradation invariants held: interactive SLO pinned, "
          "shed order == class order, no throughput collapse")

    # the live pipeline behind the same door -------------------------------
    print("\nlive: the biometric pipeline behind the front door")
    rep = run_fleet(duration_s=3.0, device=args.device)
    assert rep.lost == 0, "in-pipeline loss in the live fleet"
    for name, t in rep.frontdoor["tenants"].items():
        assert t["offered"] == t["admitted"] + t["shed"] + t["queued"], name
    print("fleet_serving OK — degradation contract held, live fleet "
          "lost no frame")


if __name__ == "__main__":
    main()
