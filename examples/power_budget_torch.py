"""Power-governed dispatch, live: a battery kit hits its watt budget
mid-mission and the governor throttles the fleet instead of the battery.

CHAMP's §4.3 power model (1-2 W per stick active, 0.3 W idle) is the
disaster-response constraint: the kit runs off a battery pack, so the
per-hub electrical draw is a hard cap, not telemetry.  This demo:

1. Streams a closed-loop burst through one 4-stick ncs2-class hub with
   no budget: ~7.2 W sustained (the unconstrained ablation).
2. Re-runs the same workload under a 4 W cap: the governor's thermal
   state machine trips (nominal -> throttled), every service cycle is
   duty-stretched, and the measured average draw lands under the cap —
   with zero frames lost.
3. Battery saver, live: starts unconstrained, then tightens the budget
   to 3 W at t=1.5 s via ``PowerGovernor.set_budget`` — the throttle
   engages mid-stream, no pause, no loss.

The port of ``examples/power_budget.py`` onto ``repro_torch`` (its engine,
bus and runtime, copied from the reference's): it prints what that
script prints, byte for byte.  It runs in virtual time and touches
no device.

Run:  PYTHONPATH=src python examples/power_budget_torch.py
"""

from repro_torch.runtime import build_battery_engine, run_battery


def describe(tag, rep):
    hub = rep.power["hubs"][0]
    print(f"  {tag:<14} {rep.throughput():7.2f} FPS  "
          f"avg {hub['avg_w']:5.2f} W  "
          f"energy {rep.power['total_j']:8.1f} J  "
          f"state={hub['state']:9s} "
          f"throttles={hub['throttle_events']} parks={hub['park_events']}")
    return hub


def main():
    print("battery kit: 4x ncs2 on one hub "
          "(full draw ~7.2 W, idle floor 1.2 W)\n")

    # 1 + 2: unconstrained vs capped, same closed-loop workload ----------
    print("budget sweep (400 frames, closed loop):")
    free = run_battery(None, n_frames=400)
    describe("unlimited", free)
    for budget in (4.0, 2.0):
        rep = run_battery(budget, n_frames=400)
        hub = describe(f"{budget:g} W cap", rep)
        assert rep.lost == 0, f"lost {rep.lost} frames"
        assert hub["avg_w"] <= budget, \
            f"cap violated: {hub['avg_w']} > {budget}"
        assert hub["throttle_events"] >= 1
    assert free.power["hubs"][0]["avg_w"] > 4.0
    print("  -> every cap held its average; deep caps park/duty-cycle\n")

    # 3: battery saver kicks in mid-mission ------------------------------
    eng = build_battery_engine(None)
    eng.feed(400, interval_s=0.0)
    eng._push_event(1.5, lambda: eng.governor.set_budget(3.0, eng.now))
    rep = eng.run(until=1e9)
    hub = rep.power["hubs"][0]
    assert rep.lost == 0, f"lost {rep.lost} frames"
    assert hub["throttle_events"] >= 1, "battery saver never engaged"
    assert rep.total_downtime() == 0.0, "throttling must not pause"
    print("battery saver at t=1.5s (3 W cap, mid-stream):")
    describe("live rebudget", rep)
    print(f"  throttled {hub['throttled_s']:.1f}s of "
          f"{rep.sim_time:.1f}s; zero loss, zero downtime")

    print("\npower_budget OK — the governor throttles the fleet, "
          "not the battery")


if __name__ == "__main__":
    main()
