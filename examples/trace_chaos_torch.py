"""Flight-recorder walkthrough: trace a seeded chaos storm, reconstruct
one frame's causal timeline, and export the whole run for Perfetto.

Runs the canonical chaos scenario (two-stage pipeline across two hubs,
hedged dispatch) under the seed-11 fault storm with tracing on, then:

1. prints the unified metrics snapshot (engine / hedge / faults /
   trace namespaces, stable dotted names);
2. reconstructs the full causal timeline of one frame that hit the
   recovery path — ingest -> dispatch (lane + why) -> transfers ->
   service -> retry/hedge activity -> completion;
3. writes Chrome trace-event JSON to ``trace_chaos.perfetto.json`` —
   open it at https://ui.perfetto.dev (or chrome://tracing) to see
   lanes, hubs, the bus, and the frame timeline as parallel tracks.

Self-asserting: tracing must not perturb the run (bit-identical to the
untraced replay), every span must close, and the export must land.

The port of ``examples/trace_chaos.py`` onto ``repro_torch`` (its engine,
bus and runtime, copied from the reference's): it prints what that
script prints, byte for byte.  It runs in virtual time and touches
no device.

Run:  PYTHONPATH=src python examples/trace_chaos_torch.py
"""
import json
import os

from repro_torch.runtime import replication as R
from repro_torch.runtime.faults import FaultPlan, QuarantinePolicy, RetryPolicy

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "trace_chaos.perfetto.json")


def storm():
    return FaultPlan.storm(11, 3.0, lanes=R.chaos_lane_names(),
                           hubs=[0, 1], links=[(0, 1)], crash_rate=1.2,
                           hang_rate=0.8, hub_loss_rate=0.15,
                           link_down_rate=0.5, corrupt_p=0.02)


def sig(rep):
    return (rep.frames_in, rep.frames_out, rep.sim_time,
            tuple(rep.latencies), tuple(sorted(rep.faults.items())))


def main():
    kw = dict(retry=RetryPolicy(), quarantine=QuarantinePolicy())
    rep = R.run_chaos(storm(), **kw, trace=True)
    rec = rep.trace

    # -- 1. the unified metrics snapshot ------------------------------------
    m = rep.metrics()
    print(f"metrics registry: {len(m)} names")
    for name in ("engine.frames.in", "engine.frames.out",
                 "engine.latency.p99", "faults.injected", "faults.retries",
                 "faults.quarantined", "hedge.issued",
                 "trace.spans_opened", "trace.entries"):
        print(f"  {name:28s} = {m[name]}")

    # -- 2. one frame's causal timeline -------------------------------------
    retried = sorted({e["frame"] for e in rec.entries()
                      if e["kind"] == "retry"})
    assert retried, "the storm must force at least one retry"
    fid = retried[0]
    print(f"\nframe {fid} causal timeline "
          f"(hit the retry path {len(retried)} frames did):")
    for e in rec.frame_trace(fid):
        t1 = e.get("t1")
        span = f" .. {t1*1e3:8.3f}" if t1 else ""
        args = e.get("args") or {}
        detail = ", ".join(f"{k}={v}" for k, v in sorted(args.items())
                           if not isinstance(v, float))
        print(f"  {e['t0']*1e3:8.3f}{span} ms  {e['kind']:<14} "
              f"[{e['track']}] {detail}")

    # -- 3. Perfetto export --------------------------------------------------
    n = rec.to_perfetto(OUT)
    print(f"\nwrote {n} trace events to {OUT}")
    print("open at https://ui.perfetto.dev -> Open trace file")

    # -- self-checks ---------------------------------------------------------
    s = rec.snapshot()
    assert s["spans_opened"] == s["spans_closed"], "span leak"
    assert s["open_frames"] == 0 and s["end_misses"] == 0
    doc = json.load(open(OUT))
    assert len(doc["traceEvents"]) == n
    untraced = R.run_chaos(storm(), **kw)
    assert sig(untraced) == sig(rep), "tracing perturbed the simulation"
    assert rep.lost == 0, "the canonical storm is zero-loss"
    print("\nOK: bit-identical to the untraced replay, all spans closed, "
          f"{rep.frames_out} frames delivered, zero loss")


if __name__ == "__main__":
    main()
