"""Replicated-lane helpers: drive Table 1 (§4.1) through the StreamEngine.

The paper's only quantitative result is near-linear FPS scaling from one
to five identical accelerators sharing a USB3 bus.  ``engine_broadcast_fps``
reproduces that experiment *inside* the VDiSK runtime: one lane group in
``broadcast`` mode with N replica cartridges whose service time is the
calibrated device compute time, on a bus calibrated from the published
rows.  ``engine_shard_fps`` runs the same hardware in ``shard`` mode —
the throughput-scaling configuration the paper motivates but does not
measure — so benchmarks can report both curves side by side.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Union

from repro_torch.bus.fabric import FabricRouter, LinkParams
from repro_torch.bus.simulator import BusParams, SharedBus, calibrated
from repro_torch.core import messages as msg
from repro_torch.core.cartridge import DeviceModel, FnCartridge
from repro_torch.runtime.engine import EngineReport, StreamEngine
from repro_torch.runtime.frontdoor import FrontDoor, Tenant
from repro_torch.runtime.registry import CapabilityRegistry

FRAME_BYTES = 150528        # 224x224x3 uint8, the paper's imagenet frame


def _params(device: Union[str, BusParams]) -> BusParams:
    return calibrated(device) if isinstance(device, str) else device


def make_inference_cartridge(params: BusParams, name: str = None,
                             capability_id: int = 7) -> FnCartridge:
    """An identity-compute cartridge whose device model carries the
    calibrated on-stick inference time."""
    spec = msg.MessageSpec(msg.IMAGE_FRAME)
    return FnCartridge(
        name or f"{params.name}_infer", lambda p, x: x, spec, spec,
        capability_id=capability_id,
        device=DeviceModel(name=params.name, service_s=params.t_comp_s))


def _device_model(d: Union[str, BusParams, DeviceModel]) -> DeviceModel:
    """Normalize a device spec: a calibrated name/BusParams becomes a
    DeviceModel carrying the on-stick inference time; a DeviceModel passes
    through (the hook for jittered / degraded straggler lanes)."""
    if isinstance(d, DeviceModel):
        return d
    p = _params(d)
    return DeviceModel(name=p.name, service_s=p.t_comp_s)


def build_replicated_engine(device: Union[str, BusParams], n_devices: int,
                            mode: str = "broadcast",
                            queue_cap: int = 8,
                            quorum: Optional[int] = None,
                            **engine_kw) -> StreamEngine:
    """One lane group holding ``n_devices`` replicas of the calibrated
    inference cartridge, all sharing one calibrated bus.  ``quorum=k``
    (broadcast only) decides each frame at the k-th replica completion.
    ``engine_kw`` passes through to ``StreamEngine`` (dispatch=, hedge=,
    ...)."""
    p = _params(device)
    reg = CapabilityRegistry()
    primary = make_inference_cartridge(p)
    reg.insert(0, primary, mode=mode, quorum=quorum)
    for i in range(1, n_devices):
        reg.add_replica(0, primary.clone(f"{primary.name}#r{i}"))
    return StreamEngine(reg, SharedBus(p), queue_cap=queue_cap, **engine_kw)


def build_mixed_engine(devices: list, mode: str = "shard",
                       queue_cap: int = 8,
                       bus: Union[str, BusParams, None] = None,
                       **engine_kw) -> StreamEngine:
    """A heterogeneous lane group: one slot whose replicas mix accelerator
    types (e.g. ``["ncs2", "coral", "coral"]``), or hand-built
    ``DeviceModel``s for straggler scenarios (slow sticks, jitter).

    All lanes share one bus — calibrated from ``bus`` (default: the first
    calibrated device in the list, else a generic USB3 hub).  The weighted
    dispatcher seeds each lane's EWMA from its own DeviceModel, so a
    mixed group load-balances by service time from the first frame.
    """
    if not devices:
        raise ValueError("need at least one device")
    devs = [_device_model(d) for d in devices]
    reg = CapabilityRegistry()
    spec = msg.MessageSpec(msg.IMAGE_FRAME)
    primary = FnCartridge(f"{devs[0].name}_infer", lambda p, x: x,
                          spec, spec, capability_id=7, device=devs[0])
    reg.insert(0, primary, mode=mode)
    for i, dv in enumerate(devs[1:], 1):
        reg.add_replica(0, primary.clone(f"{dv.name}#m{i}", device=dv))
    if bus is None:
        cal = next((d for d in devices
                    if isinstance(d, (str, BusParams))), None)
        bp = _params(cal) if cal is not None else \
            BusParams("mixed_hub", base_overhead_s=1e-4, arbitration_s=2e-4)
    else:
        bp = _params(bus)
    return StreamEngine(reg, SharedBus(bp), queue_cap=queue_cap,
                        **engine_kw)


def run_replicated(device: Union[str, BusParams], n_devices: int,
                   mode: str = "broadcast", n_frames: int = 200,
                   frame_bytes: int = FRAME_BYTES,
                   quorum: Optional[int] = None,
                   **engine_kw) -> EngineReport:
    """Stream a closed-loop burst through the replicated engine."""
    eng = build_replicated_engine(device, n_devices, mode=mode,
                                  quorum=quorum, **engine_kw)
    # interval 0 = frames always available (the experiment is closed-loop:
    # the next frame dispatches as soon as the devices can take it)
    eng.feed(n_frames, interval_s=0.0, frame_bytes=frame_bytes)
    return eng.run(until=float("inf"))


def engine_broadcast_fps(device: Union[str, BusParams], n_devices: int,
                         n_frames: int = 200,
                         quorum: Optional[int] = None) -> float:
    """Per-device FPS when every frame is broadcast to all replicas —
    the Table 1 measurement, engine-driven.  ``quorum=k`` relaxes the
    full barrier to first-k-of-N."""
    return run_replicated(device, n_devices, "broadcast",
                          n_frames, quorum=quorum).throughput()


def engine_shard_fps(device: Union[str, BusParams], n_devices: int,
                     n_frames: int = 200, **engine_kw) -> float:
    """Aggregate FPS when frames are load-balanced across replicas."""
    return run_replicated(device, n_devices, "shard", n_frames,
                          **engine_kw).throughput()


# ---------------------------------------------------------------------------
# Multi-hub fabric topologies (the layer past the single-bus saturation knee)
# ---------------------------------------------------------------------------
def _hub_bus_params(i: int, specs: list, bus: Union[str, BusParams, None],
                    fleet_default: Union[str, BusParams, None]) -> BusParams:
    """One hub's calibration: explicit ``bus``, else the hub's first
    calibrated device spec, else the fleet-wide default (so an empty hub
    pre-provisioned for hot-plug matches its siblings), else a generic
    USB3 hub."""
    cal = bus if bus is not None else next(
        (d for d in specs if isinstance(d, (str, BusParams))),
        fleet_default)
    p = _params(cal) if cal is not None else \
        BusParams("hub", base_overhead_s=1e-4, arbitration_s=2e-4)
    return dataclasses.replace(p, name=f"{p.name}_hub{i}")


def build_fabric_engine(topology: List[list], mode: str = "shard",
                        queue_cap: int = 8,
                        bus: Union[str, BusParams, None] = None,
                        link: Optional[LinkParams] = None,
                        suppression: bool = True,
                        quorum: Optional[int] = None,
                        power_budget_w=None,
                        **engine_kw) -> StreamEngine:
    """One lane group whose replicas span a multi-hub bus fabric.

    ``topology`` is one device-spec list per hub — calibrated names,
    ``BusParams``, or hand-built ``DeviceModel``s, exactly like
    ``build_mixed_engine`` — e.g. ``[["ncs2"] * 4, ["ncs2"] * 4]`` is two
    four-stick hubs (an empty list pre-provisions a hub for later
    hot-plug).  Each hub gets its own calibrated ``SharedBus`` (so
    arbitration scales with the hub's endpoint count, not the fleet's)
    and the engine routes handoffs through a ``FabricRouter`` with
    ``link`` parameters on every inter-hub channel.
    ``suppression=False`` makes the router *execute* hedge losers'
    routed handoffs instead of killing them (the contention baseline).

    ``power_budget_w`` caps each hub's electrical draw (§4.3: the
    battery budget): a scalar applies the same cap to every hub, a
    ``{hub: watts}`` dict caps hubs individually, ``None`` meters
    energy without enforcement.  See ``repro_torch.runtime.power``.
    """
    if not topology or not any(topology):
        raise ValueError("need at least one hub with at least one device")
    fleet_default = next((d for specs in topology for d in specs
                          if isinstance(d, (str, BusParams))), None)
    fabric = FabricRouter(
        [_hub_bus_params(i, specs, bus, fleet_default)
         for i, specs in enumerate(topology)],
        link=link, suppression=suppression)
    reg = CapabilityRegistry()
    spec = msg.MessageSpec(msg.IMAGE_FRAME)
    primary = None
    for h, specs in enumerate(topology):
        for j, dspec in enumerate(specs):
            dv = _device_model(dspec)
            if primary is None:
                primary = FnCartridge(f"{dv.name}_infer", lambda p, x: x,
                                      spec, spec, capability_id=7, device=dv)
                reg.insert(0, primary, mode=mode, hub=h, quorum=quorum)
            else:
                reg.add_replica(0, primary.clone(f"{dv.name}#h{h}r{j}",
                                                 device=dv), hub=h)
    return StreamEngine(reg, fabric, queue_cap=queue_cap,
                        power_budget_w=power_budget_w, **engine_kw)


def run_fabric(topology: List[list], mode: str = "shard",
               n_frames: int = 200, frame_bytes: int = FRAME_BYTES,
               **kw) -> EngineReport:
    """Closed-loop burst through a fabric engine (fabric counterpart of
    ``run_replicated``)."""
    eng = build_fabric_engine(topology, mode=mode, **kw)
    eng.feed(n_frames, interval_s=0.0, frame_bytes=frame_bytes)
    return eng.run(until=float("inf"))


def fabric_shard_fps(device: Union[str, BusParams], n_hubs: int,
                     devices_per_hub: int, n_frames: int = 200,
                     **kw) -> float:
    """Aggregate shard FPS of ``n_hubs`` hubs x ``devices_per_hub``
    identical calibrated sticks — the headline the fabric exists for:
    at equal device count, partitioned hubs beat the saturated single
    bus because each hub arbitrates only its own endpoints."""
    return run_fabric([[device] * devices_per_hub] * n_hubs,
                      mode="shard", n_frames=n_frames, **kw).throughput()


# ---------------------------------------------------------------------------
# Power-governed scenarios (§4.3 battery budgets + fabric-aware dispatch)
# ---------------------------------------------------------------------------
def build_battery_engine(power_budget_w=None, n_devices: int = 4,
                         device: Union[str, BusParams, DeviceModel] = "ncs2",
                         n_hubs: int = 1, **engine_kw) -> StreamEngine:
    """The §4.3 battery kit: ``n_hubs`` hubs of ``n_devices`` calibrated
    sticks each, shard mode, under a per-hub watt budget.  The canonical
    budget-sweep workload — shared by ``benchmarks/power_bench.py`` (the
    tracked FPS/p99-vs-watt-cap curve in ``BENCH_power.json``), the
    power test suite, and ``examples/power_budget.py``, so the
    invariants the tests pin are measured on the exact workload the
    benchmark reports.

    At ncs2 calibration one 4-stick hub draws ~7.2 W flat out against a
    1.2 W idle floor, so caps between ~2.5 and ~6.5 W exercise the
    throttle band and caps below ~2.4 W force park/duty cycling."""
    return build_fabric_engine([[device] * n_devices] * n_hubs,
                               mode="shard",
                               power_budget_w=power_budget_w, **engine_kw)


def run_battery(power_budget_w=None, n_frames: int = 200,
                frame_bytes: int = FRAME_BYTES, **kw) -> EngineReport:
    """Closed-loop burst through the battery kit (the budget-sweep
    measurement: FPS/p99/average-watts at one cap)."""
    eng = build_battery_engine(power_budget_w, **kw)
    eng.feed(n_frames, interval_s=0.0, frame_bytes=frame_bytes)
    return eng.run(until=float("inf"))


def build_routed_pipeline_engine(route_aware: bool = True,
                                 n_bursts: int = 150,
                                 load: float = 0.85,
                                 service_s: float = 0.012,
                                 **engine_kw) -> StreamEngine:
    """The canonical fabric-aware-dispatch scenario — a two-stage
    pipeline whose BOTH stages span two hubs, with a deliberately slow
    inter-hub link, shared by ``benchmarks/power_bench.py`` (the
    cross-hub traffic-share comparison in ``BENCH_power.json``) and the
    test suite.

    Every detect->embed handoff must pick a destination lane: hub-blind
    dispatch (``route_aware=False``, the pre-PR ``pick_lane``) chases
    the shortest queue across the fabric and keeps paying
    egress + link + ingress for marginal wins; fabric-aware dispatch
    folds the router's current route cost (including the link's FIFO
    backlog) into the estimate, so traffic stays hub-local unless the
    local queue really is worth the toll."""
    fast = DeviceModel(name="coral", service_s=service_s)
    reg = CapabilityRegistry()
    spec = msg.MessageSpec(msg.IMAGE_FRAME)
    det = FnCartridge("detect", lambda p, x: x, spec, spec,
                      capability_id=7, device=fast)
    reg.insert(0, det, mode="shard", hub=0)
    reg.add_replica(0, det.clone("detect#h0r1", device=fast), hub=0)
    reg.add_replica(0, det.clone("detect#h1r0", device=fast), hub=1)
    reg.add_replica(0, det.clone("detect#h1r1", device=fast), hub=1)
    emb = FnCartridge("embed", lambda p, x: x, spec, spec,
                      capability_id=8, device=fast)
    reg.insert(1, emb, mode="shard", hub=0)
    reg.add_replica(1, emb.clone("embed#h0r1", device=fast), hub=0)
    reg.add_replica(1, emb.clone("embed#h1r0", device=fast), hub=1)
    reg.add_replica(1, emb.clone("embed#h1r1", device=fast), hub=1)
    fabric = FabricRouter(
        [BusParams("hub0", bandwidth=400e6, base_overhead_s=1e-4,
                   arbitration_s=1e-4),
         BusParams("hub1", bandwidth=400e6, base_overhead_s=1e-4,
                   arbitration_s=1e-4)],
        # the hot link the ROADMAP called out: ~5 ms per routed frame
        link=LinkParams(bandwidth=30e6, overhead_s=3e-4))
    eng = StreamEngine(reg, fabric, route_aware=route_aware, **engine_kw)
    # bursty arrivals at `load` x the detect stage's aggregate capacity:
    # queues form, so the dispatcher actually faces local-vs-remote calls
    period = 5 / (load * (4 / service_s))
    for i in range(n_bursts):
        eng.feed(5, interval_s=0.0, t0=i * period)
    return eng


# ---------------------------------------------------------------------------
# Chaos fabric scenarios (deterministic fault injection, PR 7)
# ---------------------------------------------------------------------------
def chaos_lane_names() -> List[str]:
    """The deterministic cart names of the canonical chaos scenario's
    lanes, in lane order — the targets a ``FaultPlan.storm`` draws crash
    and hang victims from."""
    return ["detect", "detect#h0r1", "detect#h1r0", "detect#h1r1",
            "embed", "embed#h0r1", "embed#h1r0", "embed#h1r1"]


def build_chaos_engine(fault_plan=None, retry=None, quarantine=None,
                       n_bursts: int = 150, load: float = 0.7,
                       service_s: float = 0.012,
                       **engine_kw) -> StreamEngine:
    """The canonical fault-injection scenario — shared by
    ``benchmarks/chaos_bench.py`` (the zero-loss / goodput-retention
    contract in ``BENCH_chaos.json``) and the chaos test suite, so the
    invariants the tests pin are measured on the exact workload the
    benchmark reports.

    Same shape as the routed pipeline: a two-stage detect->embed
    pipeline with both stages spanning two hubs (2 lanes per stage per
    hub), hedged dispatch, bursty arrivals at moderate load so every
    recovery path gets headroom to act.  The topology gives every fault
    kind something to survive: a lane crash leaves three siblings, a
    hub power loss leaves the whole pipeline alive on the other hub,
    and a link-down forces reroute-or-hold on cross-hub handoffs.
    """
    fast = DeviceModel(name="coral", service_s=service_s)
    reg = CapabilityRegistry()
    spec = msg.MessageSpec(msg.IMAGE_FRAME)
    det = FnCartridge("detect", lambda p, x: x, spec, spec,
                      capability_id=7, device=fast)
    reg.insert(0, det, mode="shard", hub=0)
    reg.add_replica(0, det.clone("detect#h0r1", device=fast), hub=0)
    reg.add_replica(0, det.clone("detect#h1r0", device=fast), hub=1)
    reg.add_replica(0, det.clone("detect#h1r1", device=fast), hub=1)
    emb = FnCartridge("embed", lambda p, x: x, spec, spec,
                      capability_id=8, device=fast)
    reg.insert(1, emb, mode="shard", hub=0)
    reg.add_replica(1, emb.clone("embed#h0r1", device=fast), hub=0)
    reg.add_replica(1, emb.clone("embed#h1r0", device=fast), hub=1)
    reg.add_replica(1, emb.clone("embed#h1r1", device=fast), hub=1)
    fabric = FabricRouter(
        [BusParams("hub0", bandwidth=400e6, base_overhead_s=1e-4,
                   arbitration_s=1e-4),
         BusParams("hub1", bandwidth=400e6, base_overhead_s=1e-4,
                   arbitration_s=1e-4)],
        link=LinkParams(bandwidth=120e6, overhead_s=2e-4))
    eng = StreamEngine(reg, fabric, hedge=True,
                       fault_plan=fault_plan, retry=retry,
                       quarantine=quarantine, **engine_kw)
    period = 5 / (load * (4 / service_s))
    for i in range(n_bursts):
        eng.feed(5, interval_s=0.0, t0=i * period)
    return eng


def run_chaos(fault_plan=None, retry=None, quarantine=None,
              n_bursts: int = 150, **kw) -> EngineReport:
    """Run the canonical chaos scenario to quiescence and return its
    report.  ``until=inf`` lets every retry, quarantine lease, and
    reinstatement play out, so a zero-loss plan delivers all
    ``5 * n_bursts`` frames by the time the queue drains."""
    eng = build_chaos_engine(fault_plan, retry=retry, quarantine=quarantine,
                             n_bursts=n_bursts, **kw)
    return eng.run(until=float("inf"))


def build_lane_sweep_engine(n_lanes: int, service_s: float = 2e-4,
                            queue_cap: int = 8, **engine_kw) -> StreamEngine:
    """A fleet-scale dispatch stressor: ONE shard group of ``n_lanes``
    identical lanes on a near-free bus, so simulated events/sec is
    dominated by the engine's per-event bookkeeping — exactly what
    ``benchmarks/engine_bench.py`` sweeps to compare the heap and epoch
    cores at 100/1k/10k lanes.

    The registry is built *before* the engine so the whole fleet costs
    one rebuild, and the bus is a bare ``SharedBus`` with microsecond
    overheads: at 10k lanes a realistic USB model would serialize on
    arbitration and hide the dispatch cost being measured."""
    if n_lanes < 1:
        raise ValueError("need at least one lane")
    dev = DeviceModel(name="sweep", service_s=service_s)
    reg = CapabilityRegistry()
    spec = msg.MessageSpec(msg.IMAGE_FRAME)
    primary = FnCartridge("sweep", lambda p, x: x, spec, spec,
                          capability_id=7, device=dev)
    reg.insert(0, primary, mode="shard")
    for i in range(1, n_lanes):
        reg.add_replica(0, primary.clone(f"sweep#r{i}", device=dev))
    bus = SharedBus(BusParams("sweep", base_overhead_s=1e-5))
    return StreamEngine(reg, bus, queue_cap=queue_cap, **engine_kw)


def build_cross_hub_hedge_engine(suppression: bool = True,
                                 n_bursts: int = 120,
                                 load: float = 0.45,
                                 **engine_kw) -> StreamEngine:
    """The canonical cross-hub hedging scenario — shared by
    ``benchmarks/fabric_bench.py`` (the tracked suppression-on/off p99
    comparison in ``BENCH_fabric.json``) and the test suite, so the
    invariants the tests pin are measured on the exact workload the
    benchmark reports.

    Two jittery Coral-class lanes on hub 0, two clean ones plus the
    post-processing stage on hub 1, slow hub buses at near-critical
    load, bursty arrivals: stalls on hub 0 hedge onto hub 1 (cross-hub
    backup copies, charged ingress-only to hub 1), and loser results
    would route hub 0 -> link -> hub 1 if the router did not suppress
    them."""
    svc = 0.012
    jit = DeviceModel(name="coral_hot", service_s=svc,
                      jitter_p=0.12, jitter_mult=20.0)
    fast = DeviceModel(name="coral", service_s=svc)
    reg = CapabilityRegistry()
    spec = msg.MessageSpec(msg.IMAGE_FRAME)
    infer = FnCartridge("infer", lambda p, x: x, spec, spec,
                        capability_id=7, device=jit)
    reg.insert(0, infer, mode="shard", hub=0)
    reg.add_replica(0, infer.clone("infer#j1", device=jit), hub=0)
    reg.add_replica(0, infer.clone("infer#f0", device=fast), hub=1)
    reg.add_replica(0, infer.clone("infer#f1", device=fast), hub=1)
    reg.insert(1, FnCartridge("post", lambda p, x: x, spec, spec,
                              capability_id=8,
                              device=DeviceModel(name="post",
                                                 service_s=0.002)),
               mode="shard", hub=1)
    fabric = FabricRouter(
        [BusParams("hub0", bandwidth=60e6, base_overhead_s=3e-4,
                   arbitration_s=3e-4),
         BusParams("hub1", bandwidth=60e6, base_overhead_s=3e-4,
                   arbitration_s=3e-4)],
        link=LinkParams(bandwidth=120e6, overhead_s=2e-4),
        suppression=suppression)
    eng = StreamEngine(reg, fabric, hedge=True, hedge_quantile=0.8,
                       **engine_kw)
    period = 5 / (load * (4 / svc))
    for i in range(n_bursts):
        eng.feed(5, interval_s=0.0, t0=i * period)
    return eng


# ---------------------------------------------------------------------------
# fleet front door (multi-tenant serving) — the canonical scenario shared
# by benchmarks/serve_bench.py, tests/test_frontdoor.py and
# examples/fleet_serving.py, so the invariants the tests pin are measured
# on the exact workload the benchmark reports
# ---------------------------------------------------------------------------
FLEET_LANES = 8             # one shard group of identical fleet lanes
FLEET_SERVICE_S = 0.012     # per-frame service time -> ~666 fps nominal

# the three conventional priority tiers (paper applications): checkpoint
# operators screening live subjects (tight SLO, sheds last), recon feeds,
# and archive backfill (bulk: first to shed under overload)
FLEET_TENANTS = (
    Tenant("field_ops", priority=0, weight=8.0, slo_s=0.25, queue_cap=64),
    Tenant("recon", priority=1, weight=3.0, queue_cap=128),
    Tenant("backfill", priority=2, weight=1.0, queue_cap=256),
)
# offered-load split across the tiers for the overload sweep
FLEET_SPLIT = {"field_ops": 0.10, "recon": 0.30, "backfill": 0.60}


def fleet_capacity_fps(n_lanes: int = FLEET_LANES,
                       service_s: float = FLEET_SERVICE_S) -> float:
    return n_lanes / service_s


def build_fleet_engine(n_lanes: int = FLEET_LANES,
                       service_s: float = FLEET_SERVICE_S,
                       tenants=FLEET_TENANTS, queue_cap: int = 8,
                       headroom: float = 0.95, **engine_kw):
    """One shard group of identical lanes behind a multi-tenant front
    door.  Returns ``(engine, frontdoor)``; feed tenants with
    ``engine.feed_tenant(name, ...)``."""
    dev = DeviceModel(name="fleet", service_s=service_s)
    reg = CapabilityRegistry()
    spec = msg.MessageSpec(msg.IMAGE_FRAME)
    primary = FnCartridge("fleet", lambda p, x: x, spec, spec,
                          capability_id=7, device=dev)
    reg.insert(0, primary, mode="shard")
    for i in range(1, n_lanes):
        reg.add_replica(0, primary.clone(f"fleet#r{i}", device=dev))
    fd = FrontDoor(headroom=headroom)
    for t in tenants:
        fd.add_tenant(t)
    bus = SharedBus(BusParams("fleet", base_overhead_s=1e-5))
    eng = StreamEngine(reg, bus, queue_cap=queue_cap, frontdoor=fd,
                       **engine_kw)
    return eng, fd


def run_fleet_sweep(overload: float, duration_s: float = 20.0,
                    split=None, **build_kw) -> EngineReport:
    """Sustained offered load at ``overload`` x nominal capacity, divided
    across the tenant tiers by ``split``, each tenant arriving at its own
    even interval.  Arrivals stop at ``duration_s``; the run continues
    until the admitted backlog drains."""
    eng, fd = build_fleet_engine(**build_kw)
    cap = fleet_capacity_fps(build_kw.get("n_lanes", FLEET_LANES),
                             build_kw.get("service_s", FLEET_SERVICE_S))
    for name, frac in (split or FLEET_SPLIT).items():
        rate = overload * cap * frac
        if rate <= 0.0:
            continue
        eng.feed_tenant(name, int(rate * duration_s), interval_s=1.0 / rate)
    return eng.run(until=float("inf"))
