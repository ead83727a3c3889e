"""Heterogeneous lane group under straggler fire: the tail-latency fast
path, live.

Field scenario: a checkpoint's embed slot holds three sticks — two
healthy Coral-class lanes and one NCS2 that has degraded in the sun
(5x service time, and ~5% of its service cycles stall another 10x).
Cameras deliver frames in synchronized bursts, so all three lanes look
"idle" at burst arrival and a queue-depth dispatcher happily feeds the
degraded stick.

Three runs at the SAME offered load:

  1. baseline        — queue-depth least-loaded, no hedging
  2. EWMA dispatch   — weighted by each lane's observed service time
  3. EWMA + hedging  — tied-request backup on the best alternate lane
                       when a cycle overruns its p95 deadline, stalled
                       queues migrated to healthy lanes, loser handoffs
                       suppressed on the bus

The operator waits on p99, and p99 is what moves.

The port of ``examples/mixed_lanes.py`` onto ``repro_torch`` (its engine,
bus and runtime, copied from the reference's): it prints what that
script prints, byte for byte.  It runs in virtual time and touches
no device.

Run:  PYTHONPATH=src python examples/mixed_lanes_torch.py
"""

from repro_torch.core.cartridge import DeviceModel
from repro_torch.runtime import build_mixed_engine

N_BURSTS, BURST, PERIOD = 150, 5, 0.06   # ~83 FPS offered, capacity ~110

DEVICES = [
    DeviceModel(name="coral", service_s=0.02),
    DeviceModel(name="coral", service_s=0.02),
    DeviceModel(name="ncs2_degraded", service_s=0.10,
                jitter_p=0.05, jitter_mult=10.0),
]


def run(label, **engine_kw):
    eng = build_mixed_engine(DEVICES, **engine_kw)
    for i in range(N_BURSTS):
        eng.feed(BURST, interval_s=0.0, t0=i * PERIOD)
    rep = eng.run(until=1e9)
    n = N_BURSTS * BURST
    assert rep.frames_out == n, f"lost {rep.lost}"
    slow_frames = sum(st.processed for name, st in rep.stage_stats.items()
                      if "degraded" in name)
    print(f"[{label:13s}] p50={rep.p50()*1e3:6.1f}ms  "
          f"p95={rep.p95()*1e3:6.1f}ms  p99={rep.p99()*1e3:6.1f}ms  "
          f"throughput={rep.throughput():5.1f} FPS  "
          f"degraded-stick frames={slow_frames}")
    if rep.hedges["issued"]:
        print(f"{'':16s}hedges: issued={rep.hedges['issued']} "
              f"won_by_backup={rep.hedges['won_by_backup']} "
              f"migrated={rep.hedges['migrated']} "
              f"suppressed_handoffs={rep.bus['suppressed_transfers']}")
    return rep


def main():
    print(f"offered load: {BURST / PERIOD:.0f} FPS in bursts of {BURST} "
          f"(2x coral @50 FPS + 1x degraded ncs2 @10 FPS nominal)\n")
    base = run("pr2 baseline", dispatch="naive", hedge=False)
    run("ewma", dispatch="ewma", hedge=False)
    fast = run("ewma+hedge", dispatch="ewma", hedge=True)

    imp = base.p99() / fast.p99()
    print(f"\np99 improvement vs baseline: {imp:.1f}x "
          f"(throughput ratio {fast.throughput()/base.throughput():.3f})")
    assert imp >= 2.0, "tail-latency fast path must halve p99 here"
    assert fast.throughput() >= 0.95 * base.throughput()

    # same sticks, jitter everywhere: hedging as insurance
    print("\nhomogeneous group, every stick jittery (hedge = insurance):")
    jdev = [DeviceModel(name="coral", service_s=0.02,
                        jitter_p=0.03, jitter_mult=10.0)] * 3
    global DEVICES
    DEVICES = jdev
    unhedged = run("ewma", dispatch="ewma", hedge=False)
    hedged = run("ewma+hedge", dispatch="ewma", hedge=True)
    assert hedged.p99() < unhedged.p99()
    print(f"\nhedging cut the jitter tail "
          f"{unhedged.p99()/hedged.p99():.1f}x at equal offered load")


if __name__ == "__main__":
    main()
