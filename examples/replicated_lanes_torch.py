"""Replicated-lane scenario (paper §4.1 meets §4.2): scale out a hot stage
by plugging in more sticks, then survive losing one — live.

1. Build the detect -> embed -> match chain with ONE embedder stick: the
   35 ms embedder is the bottleneck and backlog piles up behind it.
2. Hot-plug two embedder replicas mid-stream (no pipeline pause — each
   lane joins after its own handshake + model load) and watch the lane
   group shard frames least-loaded across the sticks.
3. Pull one replica mid-mission: throughput degrades, nothing halts,
   nothing is lost.
4. Reproduce Table 1 through the same engine: a broadcast lane group of
   1..5 calibrated NCS2 sticks lands on the published FPS curve.

The port of ``examples/replicated_lanes.py`` onto ``repro_torch`` (its engine,
bus and runtime, copied from the reference's): it prints what that
script prints, byte for byte.  It runs in virtual time and touches
no device.

Run:  PYTHONPATH=src python examples/replicated_lanes_torch.py
"""

from repro_torch.bus import BusParams, SharedBus, TABLE1, calibrated
from repro_torch.core import messages as msg
from repro_torch.core.cartridge import DeviceModel, FnCartridge
from repro_torch.runtime import (CapabilityRegistry, StreamEngine,
                           engine_broadcast_fps)

SPEC = msg.MessageSpec(msg.IMAGE_FRAME)


def _cart(name, service_s, capability_id, load_s=0.4):
    return FnCartridge(name, lambda p, x: x, SPEC, SPEC,
                       capability_id=capability_id,
                       device=DeviceModel(service_s=service_s,
                                          load_s=load_s))


def scale_out_then_degrade():
    reg = CapabilityRegistry()
    reg.insert(0, _cart("detect", 0.008, 2))
    embed = _cart("embed", 0.035, 4)
    reg.insert(1, embed)
    reg.insert(2, _cart("match", 0.006, 9))
    bus = SharedBus(BusParams("usb3", base_overhead_s=1e-4,
                              arbitration_s=2e-4))
    eng = StreamEngine(reg, bus)

    eng.feed(400, interval_s=0.012)           # ~83 FPS offered load
    r1, r2 = embed.clone(), embed.clone()
    eng.schedule_add_replica(0.8, slot=1, cart=r1)    # hot-plug stick 2
    eng.schedule_add_replica(0.8, slot=1, cart=r2)    # hot-plug stick 3
    eng.schedule_remove_replica(3.5, slot=1, cart=r1)  # pull one live
    rep = eng.run(until=120)

    assert rep.frames_out == 400, f"lost {rep.lost}"
    assert rep.total_downtime() == 0.0        # replica swaps never pause
    assert not rep.alerts
    lanes = {n: rep.stage_stats[n].processed
             for n in ("embed", r1.name, r2.name)}
    print(f"[lanes] 400 frames, zero loss, zero downtime; "
          f"embed group load: {lanes}")
    print(f"[lanes] swap log: {[(round(t, 2), k) for t, k, _ in rep.swap_log]}")
    print(f"[lanes] bus contention: wait={rep.bus['wait_s']:.3f}s "
          f"arbitration={rep.bus['arbitration_s']:.3f}s "
          f"wire={rep.bus['wire_s']:.3f}s")
    assert lanes[r1.name] > 0 and lanes[r2.name] > 0


def reproduce_table1():
    print("[table1] engine-driven broadcast, ncs2 sticks:")
    for n in range(1, 6):
        fps = engine_broadcast_fps("ncs2", n)
        pub = TABLE1["ncs2"][n - 1]
        assert abs(fps - pub) <= 1.0
        print(f"  N={n}: engine {fps:5.2f} FPS vs published {pub:2d} FPS")


def main():
    scale_out_then_degrade()
    reproduce_table1()
    print("replicated_lanes OK — shard scale-out, pauseless replica "
          "swaps, Table 1 reproduced in-engine")


if __name__ == "__main__":
    main()
