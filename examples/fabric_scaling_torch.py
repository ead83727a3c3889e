"""Multi-hub bus fabric, live: scale past the single-bus saturation knee,
then hot-plug a whole new hub mid-stream.

The paper's §4.1 bus saturates at five accelerators — every stick shares
one arbitration domain, so past the knee ADDING devices REDUCES
aggregate FPS.  The fabric partitions the fleet across hubs (each with
its own calibrated SharedBus) and routes between them through the host:

1. Sweep a single calibrated ncs2-class bus from 1 to 16 sticks and
   watch the shard FPS curve peak and collapse.
2. Run the SAME 8- and 16-stick fleets as 2x4 / 4x4 hub fabrics:
   aggregate FPS keeps scaling because each hub arbitrates only its own
   endpoints.
3. Mid-stream, hot-plug a second hub of sticks into a saturated one-hub
   engine: no pause, zero loss, and throughput climbs once the new
   lanes finish their handshake.

The port of ``examples/fabric_scaling.py`` onto ``repro_torch`` (its engine,
bus and runtime, copied from the reference's): it prints what that
script prints, byte for byte.  It runs in virtual time and touches
no device.

Run:  PYTHONPATH=src python examples/fabric_scaling_torch.py
"""

from repro_torch.runtime import (build_fabric_engine, engine_shard_fps,
                           fabric_shard_fps)


def main():
    # 1. the single-bus knee ------------------------------------------------
    print("single ncs2-class bus, shard mode (aggregate FPS):")
    single = {}
    for n in (1, 2, 4, 5, 8, 10, 12, 16):
        single[n] = engine_shard_fps("ncs2", n, n_frames=200)
        print(f"  {n:>2} sticks : {single[n]:7.1f} FPS")
    knee_n = max(single, key=single.get)
    print(f"  -> saturation knee at {knee_n} sticks "
          f"({single[knee_n]:.1f} FPS); 16 sticks is "
          f"{single[16] / single[knee_n]:.2f}x the knee\n")

    # 2. same fleets, hub-partitioned --------------------------------------
    print("hub-partitioned fabrics at equal device count:")
    for hubs, per in ((2, 4), (4, 4)):
        total = hubs * per
        fps = fabric_shard_fps("ncs2", hubs, per, n_frames=200)
        print(f"  {hubs} hubs x {per} sticks ({total} total): "
              f"{fps:7.1f} FPS  ({fps / single[total]:.2f}x the "
              f"single bus, {fps / single[knee_n]:.2f}x the knee)")
        assert fps > single[total], "fabric must beat the shared bus"
        assert fps > single[knee_n], "fabric must clear the knee"
    print()

    # 3. hot-plug a second hub mid-stream -----------------------------------
    eng = build_fabric_engine([["ncs2"] * 4, []], mode="shard")
    primary = eng.registry.slots[0].cartridge
    for i in range(4):
        eng.schedule_add_replica(1.0, slot=0,
                                 cart=primary.clone(f"late#h1r{i}"), hub=1)
    eng.feed(600, interval_s=1 / 150.0)      # past one hub's capacity
    rep = eng.run(until=600)
    assert rep.lost == 0, f"lost {rep.lost} frames"
    assert rep.total_downtime() == 0.0, "hot-plug must not pause"
    hub1 = sum(rep.stage_stats[name].processed
               for name, hub in zip(rep.groups[0]["lanes"],
                                    rep.groups[0]["hubs"]) if hub == 1)
    assert hub1 > 0, "the late hub never pulled weight"
    print(f"hot-plugged hub 1 at t=1.0s: {rep.frames_out} frames, "
          f"zero loss, no pause; late hub processed {hub1} frames "
          f"({rep.throughput():.1f} FPS aggregate)")
    print(f"per-hub bus stats: "
          f"{ {h: s['transfers'] for h, s in rep.bus['hubs'].items()} }"
          f" transfers")
    print("\nfabric_scaling OK — partitioned hubs scale where the "
          "shared bus saturates")


if __name__ == "__main__":
    main()
