"""VDiSK streaming engine: discrete-event execution of cartridge pipelines.

This is the CHAMP fork of VDiSK's core loop, §2.3/§3.3 of the paper:

  * pub/sub message routing between chained cartridges over the shared bus
  * bounded inter-stage queues with backpressure ("if a cartridge's
    processing time is slower than the input rate, it can signal upstream
    modules ... to throttle the data flow")
  * hot-swap events: removal pauses the pipeline ~0.5 s, buffers in-flight
    frames, bridges the gap (PassThrough) when types allow or raises an
    operator alert; insertion pauses ~2 s (dominated by model re-load)
  * zero message loss across swaps (buffered frames replay afterward)
  * per-stage utilization -> the §4.3 power model

Replicated stages (paper §4.1, Table 1).  A capability slot is a *lane
group*: it may hold N replica cartridges (N identical sticks on the hub).
Dispatch over a group follows the slot's mode:

  * ``shard``     — each frame goes to the least-loaded replica; the group
                    streams at ~N× a single device (modulo shared-bus
                    contention).  Pulling one replica of a multi-lane group
                    degrades throughput instead of pausing the pipeline.
  * ``broadcast`` — every frame is transferred to every replica (serially
                    on the shared bus) and completes when the slowest
                    finishes: the Table 1 redundant-inference experiment.
                    With a single broadcast group the engine reproduces the
                    published 1→5-device FPS curve exactly.

Adaptive micro-batching: when a shard lane falls behind (≥2 frames
queued) it drains up to ``queue_cap`` frames in one service cycle at
``DeviceModel.batch_marginal`` marginal cost per extra frame, and the
batch crosses the bus as one transfer (amortized base overhead).

Final-stage outputs cross the bus back to the host like any other hop —
except in broadcast mode, where the per-replica result fetch (a few score
bytes) overlaps the next frame's compute window, matching how §4.1
measures pure inference FPS.

Tail-latency fast path.  Field biometrics is latency-bound: the operator
waits on the *slowest* frame.  Three mechanisms keep the dispatch hot
path tail-aware:

  * Heterogeneous lane groups — a slot may mix accelerator types
    (ncs2 + coral replicas).  ``dispatch="ewma"`` (the default) picks the
    lane minimizing estimated completion time ``(backlog + 1) * est_s``,
    where ``est_s`` is a per-lane EWMA of observed service time seeded
    from the replica's ``DeviceModel`` and updated on every
    ``_lane_done`` — a slow stick carries proportionally less load
    instead of gating the group.  ``dispatch="naive"`` keeps the PR 2
    queue-depth-only discipline as the measurable baseline.
  * Hedged dispatch (``hedge=True``, shard mode) — when a lane has not
    finished a service cycle by an adaptive deadline (a quantile of its
    own observed service distribution), the cycle's frames are
    speculatively re-enqueued on the best alternate lane.  First
    completion wins; the loser's queued copy is cancelled, an in-service
    loser finishes but its bus handoff is *suppressed*
    (``SharedBus.suppress``), and delivery stays exactly-once.  This is
    the event-driven face of ``runtime.health``'s tied-request machinery:
    lane service start/finish and every hedge flow through a
    ``HealthMonitor`` so one straggler ledger covers both paths.
  * Streaming latency histograms — ``EngineReport`` records end-to-end
    and per-stage latency into O(1)-per-sample log-spaced histograms
    (``runtime.metrics``), so p50/p95/p99 come free without the hot loop
    retaining or sorting per-frame samples.

Multi-hub bus fabric.  The ``bus`` argument may be a ``FabricRouter``
(``repro_torch.bus.fabric``) instead of a bare ``SharedBus``: devices are
partitioned across hubs (the registry tracks each replica's hub), every
transfer is charged to its route — source-hub egress, inter-hub link,
destination-hub ingress, with *per-hub* endpoint counts driving the
arbitration term — and lane groups may span hubs.  Handoffs pre-route
to the destination lane's hub (the arrival prefers a lane on the
charged hub); hedge backup copies crossing to another hub are charged
ingress-only to the *destination* hub's bus and arrive only after that
transfer completes; hedge losers are suppressed at the router, saving
link + destination-hub time before the inter-hub leg starts.  A one-hub
fabric is bit-identical to the bare bus.

Quorum broadcast.  A broadcast slot with ``quorum=k`` decides each
frame at the k-th replica completion instead of the slowest (first k of
N results win); the stragglers keep computing but their result
handoffs are suppressed on the bus.  ``quorum=None`` (or ``k >= N``)
reproduces Table 1 exactly.

Power-governed dispatch (paper §4.3).  A ``PowerGovernor``
(``runtime.power``) rides every engine: per-lane energy is integrated
from busy/idle time (O(1) per service cycle; ``EngineReport.power``
carries the per-hub/per-lane breakdown), and when per-hub watt budgets
are configured (``power_budget_w=``) a thermal state machine throttles
(duty-stretched service cycles — the stretch is forced idle, and a
throttled lane's *effective* ``est_s`` inflates in ``pick_lane`` so it
sheds load) or parks an over-budget hub (no new cycles until the draw
estimate cools; dispatch routes around parked hubs, their queued frames
wait — zero loss).  Unbudgeted runs are bit-identical to the
pre-governor engine.

Fabric-aware dispatch.  On a fabric, ``pick_lane`` is no longer
hub-blind: the pre-routed handoff decision folds the router's current
route cost (src egress + link + dst ingress, including each leg's FIFO
backlog) into the ``(backlog + 1) * est_s`` completion estimate, so a
cross-hub dispatch only wins when it beats the local queue *including*
the toll — traffic stays hub-local when the link runs hot.
``route_aware=False`` keeps the hub-blind discipline as the measurable
baseline; on a one-hub fabric (or a bare bus) the toll is constant
across lanes, so behavior is bit-identical either way.

Vectorized epoch-stepped core (``core="epoch"``, the default).  The
classic loop pops one heap event at a time and pays a linear Python scan
over lanes per dispatch; at fleet scale (10k lanes) the scan *is* the
simulator.  The epoch core drains event *cohorts* — every live event at
the earliest timestamp, in the identical seq order — via
``HeapEventQueue.pop_cohort``/``fire`` (so same-instant cancellations
still work), and reads dispatch state from lane-id-indexed NumPy arrays
(``runtime.lanestate``): ``pick_lane`` becomes an argmin over
``(backlog + 1) * est_s`` arrays and ``free_capacity`` a clipped sum.
Every ``_Lane`` mutation writes through to the arrays, so the vectorized
expressions read the very same float64 the scalar path would — the
argmin fast path is an *exact* replacement (NumPy argmin and ``min()``
both take the first minimal element), and the epoch core fires events in
exactly heap order; runs are therefore bit-identical between cores.  The
fast path engages only for plain weighted shard dispatch over
``VECTOR_PICK_MIN``-or-more lanes with no fabric toll / governor /
chaos hooks — everything else (control events, hedge alternates,
routed handoffs, chaos exclusions) keeps the scalar scan, which is
exact by construction.  ``core="heap"`` keeps the original
pop-per-event loop with the scalar scan as the measurable baseline
(``BENCH_engine.json`` tracks the epoch/heap events-per-sec ratio).

Timing is virtual (deterministic, calibrated DeviceModels); payload compute
is optionally real PyTorch (``execute_payloads=True``) so correctness tests can
assert data flows through reconfigurations unchanged.  Service-time jitter
(``DeviceModel.jitter_p``) is drawn from a hash of (lane, seq), keeping
straggler scenarios replayable.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import time
import warnings
import zlib
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional

import numpy as np

from repro_torch.bus.fabric import FabricRouter
from repro_torch.bus.simulator import BusParams, SharedBus
from repro_torch.core.cartridge import Cartridge, PassThrough
from repro_torch.core import messages as msg
from repro_torch.runtime.events import HeapEventQueue
from repro_torch.runtime import faults as flt
from repro_torch.runtime import trace as trc
from repro_torch.runtime.lanestate import LaneStateBank, TrackedDeque
from repro_torch.runtime.faults import (FaultPlan, QuarantinePolicy, RetryPolicy,
                                  frame_checksum)
from repro_torch.runtime.frontdoor import FrontDoor
from repro_torch.runtime.health import HealthMonitor, QuarantineLedger
from repro_torch.runtime.metrics import StreamingHistogram
from repro_torch.runtime.power import PowerGovernor
from repro_torch.runtime.registry import CapabilityRegistry, SlotRecord
from repro_torch.runtime.trace import FlightRecorder, MetricsRegistry, jsonable

HANDSHAKE_S = 0.35       # detection + addressing + capability handshake
REMOVE_PAUSE_S = 0.5     # paper §4.2: ~0.5 s reconfiguration on removal
# a broadcast replica's result fetch ("a few score bytes", §4.1) — the
# per-straggler handoff a quorum decision suppresses
BROADCAST_RESULT_BYTES = 256

DISPATCH_DISCIPLINES = ("ewma", "naive")
ENGINE_CORES = ("epoch", "heap")
# below this group size the argmin fast path loses to the scalar scan
# (NumPy fancy-indexing has ~µs fixed cost); both paths are exact, so the
# threshold is purely a speed knob
VECTOR_PICK_MIN = 16

# profiling-hook phase classification, by event callback name
_DISPATCH_EVENTS = frozenset((
    "_frame_arrival", "_try_start_lane", "_unpark_retry",
    "_try_start_broadcast", "_arrive_next", "_arrive_checked",
    "_hedge_copy_arrive", "_migrate_arrive", "_retry_handoff",
    "_retry_broadcast", "_reinject"))
_SERVICE_EVENTS = frozenset(("_lane_done", "_broadcast_done"))


def _event_phase(fn: Callable) -> str:
    name = getattr(fn, "__name__", "")
    if name in _DISPATCH_EVENTS:
        return "dispatch"
    if name in _SERVICE_EVENTS:
        return "service"
    return "control"

# routed handoff verdict: the destination group exists but no lane of it
# is reachable right now (dead lanes / down links) — hold and retry, never
# pretend the route is local
_BLOCKED = object()


@dataclass
class StageStats:
    processed: int = 0
    busy_s: float = 0.0
    blocked_s: float = 0.0
    batches: int = 0
    max_batch: int = 0


def _hedge_counters() -> dict:
    return {"issued": 0, "won_by_backup": 0, "wasted": 0,
            "cancelled_queued": 0, "migrated": 0,
            "cross_hub": 0, "dropped_in_flight": 0}


def _fault_counters() -> dict:
    return {"injected": 0, "lane_crash": 0, "lane_hang": 0,
            "hub_power_loss": 0, "link_down": 0, "link_up": 0,
            "hang_promoted": 0, "redispatched": 0, "retries": 0,
            "budget_exhausted": 0, "corrupt_detected": 0, "resends": 0,
            "quarantined": 0, "reinstated": 0,
            "reroute_blocked": 0, "duplicates": 0}


class _ProfileDict(dict):
    """Deprecation shim for direct ``report.profile[...]`` access.

    Phase timings now live in the metrics registry under
    ``engine.profile.*`` (``EngineReport.metrics()``); keyed reads of
    this dict warn once per call site so downstream code migrates.
    Equality/iteration stay silent — tests asserting ``profile == {}``
    and the registry's own ingest are not deprecated usage."""

    def _warn(self):
        warnings.warn(
            "direct EngineReport.profile[...] access is deprecated; read "
            "engine.profile.* from EngineReport.metrics() instead",
            DeprecationWarning, stacklevel=3)

    def __getitem__(self, key):
        self._warn()
        return dict.__getitem__(self, key)

    def get(self, key, default=None):
        self._warn()
        return dict.get(self, key, default)


@dataclass
class EngineReport:
    frames_in: int = 0
    frames_out: int = 0
    # per-frame samples, kept for debugging and exact-equality assertions
    # (tests, serve.py); all aggregate stats come from latency_hist
    latencies: list = field(default_factory=list)
    downtime: list = field(default_factory=list)  # (t0, t1, reason)
    alerts: list = field(default_factory=list)
    stage_stats: dict = field(default_factory=dict)   # lane name -> StageStats
    groups: dict = field(default_factory=dict)        # slot -> group summary
    swap_log: list = field(default_factory=list)      # (t, kind, detail)
    bus: dict = field(default_factory=dict)           # SharedBus.stats()
    bus_bytes: int = 0
    sim_time: float = 0.0
    # streaming latency accounting: O(1) per completed frame / stage visit
    latency_hist: StreamingHistogram = field(default_factory=StreamingHistogram)
    stage_hist: dict = field(default_factory=dict)    # stage name -> histogram
    hedges: dict = field(default_factory=_hedge_counters)
    power: dict = field(default_factory=dict)         # PowerGovernor.report()
    faults: dict = field(default_factory=_fault_counters)
    last_out_t: float = 0.0    # when the last frame completed — goodput
                               # denominator robust to trailing fault events
    # per-phase wall time (dispatch/service/bookkeeping/control), filled
    # only when the engine runs with profile=True.  Keyed access is
    # deprecated in favour of metrics() -> engine.profile.*
    profile: dict = field(default_factory=_ProfileDict)
    # event-queue lifetime counters (HeapEventQueue.stats()), filled at
    # the end of run()
    events: dict = field(default_factory=dict)
    # FrontDoor.summary() — per-tenant admission/shed/SLO ledger, filled
    # at the end of run() when a front door is attached
    frontdoor: dict = field(default_factory=dict)
    # the flight recorder, when the engine ran with trace enabled
    trace: Optional[FlightRecorder] = None

    def energy_j(self) -> float:
        """Total electrical energy the fleet drew (joules, virtual time)."""
        return self.power.get("total_j", 0.0)

    def avg_power_w(self) -> float:
        return self.power.get("avg_w", 0.0)

    @property
    def lost(self) -> int:
        return self.frames_in - self.frames_out

    def throughput(self) -> float:
        # zero-completion safe: an idle/empty run reports 0.0, not a crash
        if not self.frames_out or self.sim_time <= 0.0:
            return 0.0
        return self.frames_out / self.sim_time

    def mean_latency(self) -> float:
        # exact: the histogram keeps a running total/count (not binned),
        # so this is O(1) and zero-completion safe
        return self.latency_hist.mean()

    def p50(self) -> float:
        return self.latency_hist.p50()

    def p95(self) -> float:
        return self.latency_hist.p95()

    def p99(self) -> float:
        return self.latency_hist.p99()

    def latency_summary(self) -> dict:
        """End-to-end + per-stage latency percentiles (hedge-aware: only
        winning copies ever reach the end-to-end histogram)."""
        return {
            "end_to_end": self.latency_hist.summary(),
            "stages": {k: h.summary() for k, h in self.stage_hist.items()},
            "hedges": dict(self.hedges),
        }

    def merged_downtime(self) -> list:
        """Downtime windows with overlaps coalesced.  Swap pauses stack
        (``_pause`` extends ``paused_until``) and a halt window can span
        a pause, so the raw ``downtime`` entries may overlap; summing
        them double-counts the shared seconds.  Returns disjoint
        ``(t0, t1)`` intervals, sorted."""
        spans = sorted((t0, t1) for t0, t1, _ in self.downtime if t1 > t0)
        merged: list = []
        for t0, t1 in spans:
            if merged and t0 <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], t1)
            else:
                merged.append([t0, t1])
        return [(t0, t1) for t0, t1 in merged]

    def total_downtime(self) -> float:
        return sum(t1 - t0 for t0, t1 in self.merged_downtime())

    def availability(self) -> float:
        """Fraction of the run the pipeline accepted work, computed over
        the merged (non-overlapping) downtime windows."""
        if self.sim_time <= 0.0:
            return 1.0
        return max(0.0, 1.0 - self.total_downtime() / self.sim_time)

    def metrics(self) -> MetricsRegistry:
        """One namespaced snapshot of every counter the run produced.

        Stable dotted names (``engine.*``, ``hedge.*``, ``faults.*``,
        ``power.*``, ``bus.*``, ``stage.*``, ``trace.*``) so dashboards
        and regression gates can key on them across releases.  Scalar
        leaves only — list-valued stats (per-frame latencies, downtime
        windows) stay on the report itself."""
        reg = MetricsRegistry()
        reg.set("engine.frames.in", self.frames_in)
        reg.set("engine.frames.out", self.frames_out)
        reg.set("engine.frames.lost", self.lost)
        reg.set("engine.sim_time_s", self.sim_time)
        reg.set("engine.throughput_fps", self.throughput())
        reg.set("engine.availability", self.availability())
        reg.set("engine.downtime_s", self.total_downtime())
        reg.set("engine.alerts", len(self.alerts))
        reg.set("engine.swaps", len(self.swap_log))
        reg.ingest("engine.latency", self.latency_hist.summary())
        reg.ingest("engine.events", self.events)
        # dict.copy keeps the deprecation shim silent on internal reads
        reg.ingest("engine.profile", dict.copy(self.profile))
        reg.ingest("hedge", self.hedges)
        reg.ingest("faults", self.faults)
        reg.ingest("bus", self.bus)
        reg.ingest("power",
                   {k: v for k, v in self.power.items() if k != "lanes"})
        for name, tstats in self.frontdoor.get("tenants", {}).items():
            reg.ingest(f"tenant.{name}", tstats)
        for name, hist in self.stage_hist.items():
            reg.ingest(f"stage.{name}", hist.summary())
        for name, st in self.stage_stats.items():
            reg.ingest(f"lane.{name}", dataclasses.asdict(st))
        if self.trace is not None:
            reg.ingest("trace", self.trace.snapshot())
        return reg

    def to_dict(self) -> dict:
        """JSON-safe dict with a stable schema (numpy scalars coerced)."""
        return jsonable({
            "schema": "champ.engine_report.v1",
            "frames": {"in": self.frames_in, "out": self.frames_out,
                       "lost": self.lost},
            "sim_time_s": self.sim_time,
            "last_out_t": self.last_out_t,
            "throughput_fps": self.throughput(),
            "availability": self.availability(),
            "latency": self.latency_summary(),
            "downtime": [list(w) for w in self.downtime],
            "downtime_merged": [list(w) for w in self.merged_downtime()],
            "alerts": list(self.alerts),
            "swap_log": [list(e) for e in self.swap_log],
            "groups": self.groups,
            "stage_stats": {k: dataclasses.asdict(v)
                            for k, v in self.stage_stats.items()},
            "bus": self.bus,
            "bus_bytes": self.bus_bytes,
            "power": self.power,
            "faults": self.faults,
            "hedges": dict(self.hedges),
            "events": self.events,
            "frontdoor": self.frontdoor,
            "profile": dict.copy(self.profile),
            "metrics": self.metrics().snapshot(),
        })

    def to_json(self, path: Optional[str] = None,
                indent: Optional[int] = None) -> str:
        """Serialize ``to_dict()``; optionally also write it to ``path``."""
        text = json.dumps(self.to_dict(), indent=indent, sort_keys=True)
        if path is not None:
            with open(path, "w") as fh:
                fh.write(text)
        return text


class _Lane:
    """One physical replica device inside a lane group.

    Dispatch-relevant scalars (``est_s``, ``ready_at``, busy/held
    occupancy, queue depth) are mirrored into a ``LaneStateBank`` row so
    the vectorized pick path reads them as arrays.  Scalar *reads* stay
    plain attributes (no property overhead on the hot path); the few
    mutation sites go through ``set_*`` write-through helpers (or the
    ``TrackedDeque`` for queue depth)."""

    def __init__(self, cart: Cartridge, queue_cap: int,
                 bank: LaneStateBank):
        self.cart = cart
        self.bank = bank
        self.lid = bank.alloc()            # row in the lane-state arrays
        self.queue: deque = TrackedDeque(bank, self.lid)
        self.queue_cap = queue_cap
        self.busy = False
        self.held: Optional[list] = None   # finished batch, downstream full
        self.ready_at = 0.0                # handshake+load gate for live adds
        self.parked_wait = False           # an unpark retry is already queued
        self.stats = StageStats()
        self.pos = 0                       # last known chain position
        self.slot = -1                     # last known capability slot
        self.hub = 0                       # fabric hub this device plugs into
        self.bfree_at = 0.0                # broadcast: this replica's own
                                           # previous frame's finish time
        # chaos-fabric state (inert unless a FaultPlan is installed)
        self.inflight = None               # (svc_handle, batch) in service
        self.wd_handle: Optional[int] = None  # armed watchdog event
        self.cycle_seq = 0                 # guards stale watchdog firings
        self.hang_next = False             # hang fault latched while idle
        # per-lane service-time model: EWMA point estimate (seeded from the
        # calibrated DeviceModel) + streaming distribution for the hedge
        # deadline quantile.  Both are per batch-normalized frame cost.
        self.est_s = cart.device.service_s
        bank.est_s[self.lid] = self.est_s
        self.svc_hist = StreamingHistogram(lo=1e-7, hi=1e4)

    def observe(self, svc_norm: float, alpha: float):
        """Online service-time update on every completed service cycle."""
        self.est_s += alpha * (svc_norm - self.est_s)
        self.bank.est_s[self.lid] = self.est_s
        self.svc_hist.record(svc_norm)

    def set_busy(self, busy: bool):
        self.busy = busy
        self.bank.busy[self.lid] = 1 if busy else 0

    def set_held(self, held: Optional[list]):
        self.held = held
        self.bank.heldn[self.lid] = len(held) if held else 0

    def set_ready_at(self, t: float):
        self.ready_at = t
        self.bank.ready_at[self.lid] = t

    def reset_queue(self, items=()):
        """Replace the queue contents (migration keep-list)."""
        self.queue = TrackedDeque(self.bank, self.lid, items)

    def backlog(self) -> int:
        return len(self.queue) + (1 if self.busy else 0) + \
            (len(self.held) if self.held else 0)


class _HedgeTask:
    """Tracks one hedged message through a lane group: which copies exist,
    where, and whether the race is decided.  Exactly-once delivery hinges
    on ``copies`` reaching zero exactly when every live copy has been
    delivered (winner), cancelled (queued loser), or suppressed
    (in-service loser)."""

    __slots__ = ("seq", "message", "primary", "backup", "check_handle",
                 "winner", "copies")

    def __init__(self, seq: int, message: msg.Message, primary: _Lane,
                 check_handle: Optional[int]):
        self.seq = seq
        self.message = message         # as enqueued at this stage (pre-fn)
        self.primary = primary
        self.backup: Optional[_Lane] = None
        self.check_handle = check_handle
        self.winner: Optional[_Lane] = None
        self.copies = 1


class _LaneGroup:
    """All replicas of one capability slot, plus broadcast-mode state."""

    def __init__(self, rec: SlotRecord, queue_cap: int):
        self.slot = rec.slot
        self.mode = rec.mode
        self.quorum = rec.quorum
        self.lanes: List[_Lane] = []
        self.lane_ids: set = set()         # id(lane) index for O(1) lookup
        self.lids = np.empty(0, dtype=np.int64)  # member rows, lane order
        self.queue_cap = queue_cap
        self.bqueue: deque = deque()       # broadcast: group-level queue
        self.bbusy = False
        self.bheld: Optional[msg.Message] = None
        self.pos = 0

    @property
    def name(self) -> str:
        return self.lanes[0].cart.name if self.lanes else f"slot{self.slot}"

    def refresh_lids(self):
        """Re-derive the member lane-id array (after any membership
        change); index i of ``lids`` is ``lanes[i]``, so an argmin over
        bank rows maps straight back to a lane."""
        self.lids = np.fromiter((l.lid for l in self.lanes),
                                dtype=np.int64, count=len(self.lanes))

    def free_capacity(self, bank: Optional[LaneStateBank] = None) -> int:
        if self.mode == "broadcast":
            return max(self.queue_cap - len(self.bqueue), 0)
        if bank is not None and len(self.lanes) >= VECTOR_PICK_MIN:
            return int(np.maximum(self.queue_cap - bank.qlen[self.lids],
                                  0).sum())
        return sum(max(self.queue_cap - len(l.queue), 0) for l in self.lanes)

    def _pick_vector(self, now: float,
                     bank: LaneStateBank) -> Optional[_Lane]:
        """Argmin-over-arrays fast path for plain weighted shard dispatch.

        Bit-exact vs. the scalar scan: the arrays hold the very same
        float64s the attributes do, ``(backlog + 1) * est_s`` runs the
        same float ops elementwise, masking the not-ready pool with +inf
        preserves index order, and ``np.argmin`` returns the *first*
        minimal element exactly like ``min()``."""
        lids = self.lids
        eta = (bank.qlen[lids] + bank.busy[lids] + bank.heldn[lids] + 1) \
            * bank.est_s[lids]
        ready = bank.ready_at[lids] <= now
        if not ready.all() and ready.any():
            eta = np.where(ready, eta, np.inf)
        return self.lanes[int(np.argmin(eta))]

    def pick_lane(self, now: float, weighted: bool = True,
                  exclude: Optional[_Lane] = None,
                  prefer_hub: Optional[int] = None,
                  toll=None, est_scale=None,
                  parked=None, dead=None,
                  bank: Optional[LaneStateBank] = None) -> Optional[_Lane]:
        """Dispatch choice; prefers lanes past their handshake gate.

        ``weighted`` (the default) minimizes estimated completion time of
        one more frame, ``(backlog + 1) * est_s`` — with heterogeneous or
        drifting replicas the slow stick only wins when the fast lanes'
        queues outweigh its service-time handicap.  For equal ``est_s``
        the ordering degenerates to plain least-loaded, so homogeneous
        groups behave exactly like the unweighted discipline.
        ``weighted=False`` is the queue-depth-only baseline.  ``exclude``
        lets the hedge path pick the best *alternate* lane.
        ``prefer_hub`` narrows the pool to one fabric hub when possible —
        a routed handoff already paid to reach that hub, so the arrival
        lands there unless the hub has no lanes left.

        ``toll`` (lane -> seconds) adds the routed transfer cost to the
        weighted estimate — fabric-aware dispatch: a remote lane only
        wins when it beats the local queue *including* the route.  On a
        one-hub fabric the toll is constant across lanes, so the argmin
        (and therefore the run) is unchanged.  ``est_scale``
        (lane -> multiplier) inflates a throttled lane's effective
        ``est_s``.  ``parked`` (hub -> bool) steers work away from
        power-parked hubs; they remain a last resort so frames are never
        dropped when every lane of a group is parked (they queue and run
        after the unpark).

        ``dead`` (lane -> bool) is a *hard* exclusion — a crashed or
        quarantined lane must never be picked, not even as a last
        resort.  With every lane dead the pick returns None and the
        caller buffers the frame (zero loss; reinstatement drains it).

        ``bank`` (the epoch core's lane-state arrays) enables the
        ``_pick_vector`` fast path when no other hook narrows or rescores
        the pool — the O(n) scan collapses to one argmin.
        """
        if bank is not None and weighted and exclude is None \
                and prefer_hub is None and toll is None \
                and est_scale is None and parked is None and dead is None \
                and len(self.lanes) >= VECTOR_PICK_MIN:
            return self._pick_vector(now, bank)
        lanes = self.lanes if exclude is None else \
            [l for l in self.lanes if l is not exclude]
        if dead is not None:
            lanes = [l for l in lanes if not dead(l)]
        if not lanes:
            return None
        ready = [l for l in lanes if l.ready_at <= now]
        pool = ready or lanes
        if parked is not None:
            awake = [l for l in pool if not parked(l.hub)]
            if awake:
                pool = awake
        if prefer_hub is not None:
            on_hub = [l for l in pool if l.hub == prefer_hub]
            if on_hub:
                pool = on_hub
        if weighted:
            if toll is None and est_scale is None:
                return min(pool, key=lambda l: (l.backlog() + 1) * l.est_s)

            def eta(l):
                est = (l.backlog() + 1) * l.est_s
                if est_scale is not None:
                    est *= est_scale(l)
                if toll is not None:
                    est += toll(l)
                return est
            return min(pool, key=eta)
        return min(pool, key=lambda l: (len(l.queue) + (1 if l.busy else 0)))


class StreamEngine:
    """Lane-group topology engine. Groups are rebuilt on registry events."""

    # fraction of a frame's remaining SLO budget the hedge deadline may
    # consume before forking a backup (front-door tenants with slo_s)
    slo_hedge_frac = 0.5

    def __init__(self, registry: CapabilityRegistry, bus,
                 *, queue_cap: int = 8, execute_payloads: bool = False,
                 microbatch: bool = True, event_queue=None,
                 dispatch: str = "ewma", hedge: bool = False,
                 hedge_quantile: float = 0.95, hedge_min_obs: int = 8,
                 hedge_margin: float = 1.25, ewma_alpha: float = 0.25,
                 governor: Optional[PowerGovernor] = None,
                 power_budget_w=None, route_aware: bool = True,
                 fault_plan: Optional[FaultPlan] = None,
                 retry: Optional[RetryPolicy] = None,
                 quarantine: Optional[QuarantinePolicy] = None,
                 watchdog_margin: float = 8.0,
                 core: str = "epoch", profile: bool = False,
                 trace=None, trace_sample: int = 1,
                 trace_capacity: int = 65536,
                 frontdoor: Optional[FrontDoor] = None):
        if dispatch not in DISPATCH_DISCIPLINES:
            raise ValueError(f"unknown dispatch discipline {dispatch!r}")
        if core not in ENGINE_CORES:
            raise ValueError(f"unknown engine core {core!r}")
        self.core = core
        self.profile_enabled = bool(profile)
        self._prof = {"dispatch_s": 0.0, "service_s": 0.0,
                      "control_s": 0.0, "bookkeeping_s": 0.0,
                      "events": {"dispatch": 0, "service": 0, "control": 0}}
        # lane-id-indexed dispatch state; row 0 is a reserved scrap row
        # that retired lanes point at, so a late in-flight completion on a
        # detached lane can never scribble on a recycled row
        self.lanestate = LaneStateBank()
        self._scrap_lid = self.lanestate.alloc()
        # the heap core keeps the scalar scan as the measurable baseline
        self._pick_bank = self.lanestate if core == "epoch" else None
        self.registry = registry
        self.bus = bus                  # SharedBus, or a FabricRouter
        self.fabric: Optional[FabricRouter] = \
            bus if isinstance(bus, FabricRouter) else None
        self.queue_cap = queue_cap
        self.execute_payloads = execute_payloads
        self.microbatch = microbatch
        self.dispatch = dispatch
        # energy metering is always on; budgets engage the state machine
        self.governor = governor if governor is not None \
            else PowerGovernor(budget_w=power_budget_w)
        self.route_aware = route_aware
        self.hedge = hedge
        self.hedge_quantile = hedge_quantile
        self.hedge_min_obs = hedge_min_obs
        self.hedge_margin = hedge_margin
        self.ewma_alpha = ewma_alpha
        # the tied-request ledger shared with the polled datacenter path:
        # lane service start/finish + every hedge land here, and its
        # straggler_factor doubles as the cold-start hedge deadline factor
        self.health = HealthMonitor()
        self.now = 0.0
        self.paused_until = 0.0
        self.halted_since: Optional[float] = None   # missing capability
        self._in_swap = False
        self.report = EngineReport()
        # O(log n) event core; benchmarks inject events.ListEventQueue to
        # measure the linear-scan baseline on the same workload
        self._events = event_queue if event_queue is not None \
            else HeapEventQueue()
        self._groups: List[_LaneGroup] = []
        self._live_groups: set = set()       # id(group) of current groups
        self._group_by_slot: dict = {}       # slot -> _LaneGroup
        self._slot_index: dict = {}          # slot -> chain position
        self._lane_by_cart: dict = {}        # id(cart) -> _Lane (live lanes)
        self._retired_stats: dict = {}       # name -> StageStats (unplugged)
        self._hold_buffer: deque = deque()   # frames buffered during pauses
        self._hedges: dict = {}              # (slot, seq) -> _HedgeTask
        self._frame_seq = itertools.count()
        # chaos fabric: everything below is inert (and every chaos branch
        # in the hot path is skipped) until a non-empty FaultPlan is
        # installed, so fault-free runs stay bit-identical to Table 1
        self.faults: FaultPlan = fault_plan or FaultPlan()
        self.retry = retry or RetryPolicy()
        self.qledger = QuarantineLedger(quarantine)
        self.watchdog_margin = watchdog_margin
        self._chaos = False
        self._down: set = set()              # id(lane) of failed lanes
        self._delivered: set = set()         # seqs delivered (chaos only)
        # flight recorder: ONE flag gates every instrumentation branch
        # (the _chaos lesson) — trace=None means zero touched state, so
        # untraced runs are structurally bit-identical to Table 1
        if isinstance(trace, FlightRecorder):
            self._trace: Optional[FlightRecorder] = trace
        elif trace:
            self._trace = FlightRecorder(
                capacity=trace_capacity, sample=trace_sample,
                seed=fault_plan.seed if fault_plan is not None else 0)
        else:
            self._trace = None
        self._svc_sids: dict = {}            # id(lane) -> open service sids
        if self._trace is not None:
            rec = self._trace
            rec.clock = lambda: self.now
            self.report.trace = rec
            self.qledger.tracer = rec
            self.governor.tracer = rec
        # fleet front door: every frame source flows through it; a
        # trivial door (one default tenant, no caps) is a pure
        # pass-through, so single-operator runs stay bit-identical
        self._fd: Optional[FrontDoor] = None
        registry.subscribe(self._on_registry_event)
        self._rebuild()
        if fault_plan is not None:
            self.install_fault_plan(fault_plan)
        if frontdoor is not None:
            self.attach_frontdoor(frontdoor)

    # -- pipeline construction ------------------------------------------------
    def _rebuild(self):
        """Re-derive lane groups from the registry.  Group and lane objects
        are *reused* (keyed by slot / cartridge identity) so in-flight
        events referencing them stay valid across hot-swaps."""
        old_groups = self._groups
        # snapshot lane membership NOW: group objects are reused below, so
        # their .lanes lists get overwritten before the rescue pass runs
        old_membership = [(g, list(g.lanes)) for g in old_groups]
        old_group_by_slot = {g.slot: g for g in old_groups}
        records = self.registry.records()
        validate_chain([r.cartridge for r in records])
        self._groups = []
        kept_lanes = set()
        for i, rec in enumerate(records):
            g = old_group_by_slot.get(rec.slot) or _LaneGroup(
                rec, self.queue_cap)
            g.mode = rec.mode
            g.quorum = rec.quorum
            g.pos = i
            g.lanes = []
            for cart in rec.replicas:
                lane = self._lane_by_cart.get(id(cart)) or _Lane(
                    cart, self.queue_cap, self.lanestate)
                self._lane_by_cart[id(cart)] = lane
                lane.pos = i
                lane.slot = rec.slot
                lane.hub = self.registry.hub_of(cart)
                self.lanestate.hub[lane.lid] = lane.hub
                if self.fabric is not None and \
                        not 0 <= lane.hub < self.fabric.n_hubs:
                    # fail at (hot-)plug time, not frames later inside a
                    # routed transfer deep in the event loop
                    raise ValueError(
                        f"{cart.name} placed on hub {lane.hub}, but the "
                        f"fabric has hubs 0..{self.fabric.n_hubs - 1}")
                g.lanes.append(lane)
                kept_lanes.add(id(lane))
            g.lane_ids = {id(l) for l in g.lanes}
            g.refresh_lids()
            self._groups.append(g)
        # rescue queued/held frames of lanes and groups that left the chain.
        # A held batch has already been serviced: when the lane's slot
        # survives (replica detach) it must re-enter DOWNSTREAM of the
        # group, not through it again; when the whole slot vanished, its
        # old position already maps to the stage that shifted into the gap.
        kept_slots = {g.slot for g in self._groups}
        for g, lanes in old_membership:
            held_off = 1 if g.slot in kept_slots else 0
            for l in lanes:
                if id(l) not in kept_lanes:
                    self._rescue_lane(l, l.pos, held_off)
            if g.slot not in kept_slots:
                for m in g.bqueue:
                    self._hold_buffer.append((g.pos, m))
                g.bqueue.clear()
                if g.bheld is not None:
                    self._hold_buffer.append((g.pos, g.bheld))
                    g.bheld = None
        # prune unplugged lanes (no unbounded growth across swaps) but keep
        # a handle on their stats — the StageStats object is shared with any
        # still-in-flight batch, so late updates remain visible in reports
        for key, lane in list(self._lane_by_cart.items()):
            if id(lane) not in kept_lanes:
                self._retired_stats[lane.cart.name] = lane.stats
                del self._lane_by_cart[key]
                # recycle the bank row; the lane object (which in-flight
                # events may still reference) is repointed at the scrap
                # row so its late writes land nowhere meaningful
                self.lanestate.release(lane.lid)
                lane.lid = lane.queue._lid = self._scrap_lid
        self._group_by_slot = {g.slot: g for g in self._groups}
        self._live_groups = {id(g) for g in self._groups}
        # records() is slot-sorted, so position == sorted-slot index
        self._slot_index = {g.slot: i for i, g in enumerate(self._groups)}
        # power meter follows the physical population (detached sticks
        # stop drawing; new ones start accruing idle immediately)
        self._sync_governor()

    def _sync_governor(self):
        """Reconcile the power meter with the *powered* population: a
        crashed lane or a hub that lost power stops drawing exactly like
        a detached stick (and resumes idle draw on reinstatement)."""
        self.governor.sync(self.now, {
            id(lane.cart): (lane.cart.name, lane.cart.device, lane.hub)
            for lane in self._lane_by_cart.values()
            if id(lane) not in self._down})

    def _rescue_lane(self, lane: _Lane, pos: int, held_off: int = 0):
        for m in lane.queue:
            task = self._hedges.get((lane.slot, m.seq))
            if task is not None and m.meta.get("_hedge_copy"):
                if task.copies > 1:
                    # a speculative duplicate whose other copy is still
                    # live: dropping it preserves exactly-once delivery
                    task.copies -= 1
                    task.backup = None
                    self.report.hedges["cancelled_queued"] += 1
                    continue
                # defensive: last live copy — promote it to sole owner
                del self._hedges[(lane.slot, m.seq)]
                m.meta.pop("_hedge_copy", None)
            self._hold_buffer.append((pos, m))
        lane.queue.clear()
        if lane.held is not None:
            for m in lane.held:
                self._hold_buffer.append((pos + held_off, m))
            lane.set_held(None)

    def _on_registry_event(self, kind: str, rec):
        # engine-driven swaps rebuild once at the end of their transaction;
        # direct registry edits (tests) get a safe rebuild here.
        if not self._in_swap:
            self._rebuild()

    def _group_of_lane(self, lane: _Lane) -> Optional[_LaneGroup]:
        g = self._group_by_slot.get(lane.slot)
        if g is not None and id(lane) in g.lane_ids:
            return g
        return None

    def _n_endpoints(self, hub: Optional[int] = None) -> int:
        """Arbitration contention count: the whole fleet on a single bus,
        or — with a fabric — just the endpoints sharing one hub."""
        if hub is None or self.fabric is None:
            return self.registry.n_endpoints() or 1
        return self.registry.n_endpoints_on(hub) or 1

    def _gov_pick_kwargs(self) -> dict:
        """Power-aware dispatch hooks for ``pick_lane`` — empty (zero
        overhead) unless a budget is configured."""
        if not self.governor.active:
            return {}
        gov, now = self.governor, self.now
        return {"est_scale": lambda l: gov.inflation(now, l.hub),
                "parked": lambda h: gov.parked(now, h)}

    def _pick_kwargs(self) -> dict:
        """All dispatch hooks for ``pick_lane``: the governor's (when a
        budget is active) plus — under a fault plan — the chaos fabric's
        hard exclusion of down lanes and the quarantine ledger's
        probation penalty (a reinstated lane re-earns traffic instead of
        re-entering the EWMA loop at full weight)."""
        kw = self._gov_pick_kwargs()
        if not self._chaos:
            return kw
        down = self._down
        kw["dead"] = lambda l: id(l) in down
        ql, now = self.qledger, self.now
        gov_scale = kw.get("est_scale")
        if gov_scale is None:
            kw["est_scale"] = lambda l: ql.penalty(l.cart.name, now)
        else:
            kw["est_scale"] = \
                lambda l: gov_scale(l) * ql.penalty(l.cart.name, now)
        return kw

    def _route_hub(self, idx: int, src_hub: Optional[int] = None,
                   nbytes: int = 0) -> Optional[int]:
        """Where the router should land a handoff bound for stage ``idx``:
        the hub of the lane the group would dispatch to right now.  None
        for the sink, a broadcast group (host-staged: its per-lane ingress
        is charged at broadcast start), or an empty group — those routes
        stay local to the source hub.

        With ``src_hub`` given (fabric-aware dispatch, the default) the
        choice charges each candidate the router's *current* cost of
        reaching its hub — src egress + link + ingress, including FIFO
        backlog — so a cross-hub lane only wins when it beats the local
        queue including the toll.  ``route_aware=False`` (or the naive
        discipline) keeps the hub-blind estimate as the measurable
        baseline.

        Under a fault plan the choice is also reachability-aware: down
        lanes are excluded, and with any fabric link down so are lanes
        the source hub cannot reach.  If the group has lanes but none is
        reachable, returns the ``_BLOCKED`` sentinel — the caller must
        hold the batch and retry, never route as if local."""
        if self.fabric is None or idx >= len(self._groups):
            return None
        g = self._groups[idx]
        if g.mode == "broadcast":
            return None
        weighted = self.dispatch == "ewma"
        toll = None
        if self.route_aware and weighted and src_hub is not None:
            fab, now = self.fabric, self.now
            toll = lambda l: fab.route_cost(src_hub, l.hub, nbytes, t=now)
        kw = self._pick_kwargs()
        guarded = False
        if self._chaos and src_hub is not None \
                and self.fabric.has_down_links():
            guarded = True
            fab2, prev_dead = self.fabric, kw.get("dead")
            kw["dead"] = lambda l: ((prev_dead is not None and prev_dead(l))
                                    or not fab2.link_ok(src_hub, l.hub))
        lane = g.pick_lane(self.now, weighted=weighted, toll=toll,
                           bank=self._pick_bank, **kw)
        if lane is None and g.lanes and (guarded or self._chaos):
            return _BLOCKED
        return lane.hub if lane is not None else None

    # -- event queue ----------------------------------------------------------
    def _push_event(self, t: float, fn: Callable, *args) -> int:
        return self._events.push(t, fn, args)

    def _run_heap(self, until: float):
        """The classic pop-per-event loop (``core="heap"``)."""
        ev = self._events
        while len(ev) and ev.peek_time() <= until:
            t, _, fn, args = ev.pop()
            self.now = max(self.now, t)
            fn(*args)

    def _run_epoch(self, until: float):
        """Cohort-draining loop (``core="epoch"``): all live events at the
        earliest timestamp come out in one queue call, in the identical
        seq order the heap loop would pop them.  ``fire`` skips members
        cancelled by an earlier member of the same cohort; events pushed
        *during* a cohort at the same instant get larger seqs and form
        the next cohort at that timestamp, exactly matching heap order."""
        ev = self._events
        fire = ev.fire
        while len(ev) and ev.peek_time() <= until:
            cohort = ev.pop_cohort()
            t = cohort[0][0]
            if t > self.now:
                self.now = t
            for _, h, fn, args in cohort:
                if fire(h):
                    fn(*args)

    def _run_profiled(self, until: float):
        """Either core, with per-event phase timing (``profile=True`` —
        kept out of the unprofiled loops so profiling costs nothing when
        off)."""
        ev = self._events
        prof = self._prof
        counts = prof["events"]
        clock = time.perf_counter
        cohorts = self.core == "epoch"
        while len(ev) and ev.peek_time() <= until:
            if cohorts:
                cohort = ev.pop_cohort()
                t = cohort[0][0]
                if t > self.now:
                    self.now = t
            else:
                e = ev.pop()
                self.now = max(self.now, e[0])
                cohort = (e,)
            for _, h, fn, args in cohort:
                # fire() must interleave with execution: an earlier
                # member of this cohort may cancel a later one
                if cohorts and not ev.fire(h):
                    continue
                phase = _event_phase(fn)
                t0 = clock()
                fn(*args)
                prof[phase + "_s"] += clock() - t0
                counts[phase] += 1

    def run(self, until: float) -> EngineReport:
        if self.profile_enabled:
            self._run_profiled(until)
            t_book = time.perf_counter()
        elif self.core == "heap":
            self._run_heap(until)
        else:
            self._run_epoch(until)
        # sim_time = when work actually finished (not the horizon)
        self.report.sim_time = self.now
        self.report.bus_bytes = self.bus.bytes_moved
        self.report.bus = self.bus.stats()
        self.report.events = self._events.stats()
        self.report.power = self.governor.report(self.now)
        if self._fd is not None:
            self.report.frontdoor = self._fd.summary()
        if self._chaos:
            self.report.faults["quarantine"] = self.qledger.summary()
        self.report.stage_stats.update(self._retired_stats)
        for lane in self._lane_by_cart.values():
            self.report.stage_stats[lane.cart.name] = lane.stats
        for g in self._groups:
            self.report.groups[g.slot] = {
                "mode": g.mode,
                "quorum": g.quorum,
                "lanes": [l.cart.name for l in g.lanes],
                "devices": [l.cart.device.name for l in g.lanes],
                "hubs": [l.hub for l in g.lanes],
                # broadcast: how far each replica's own compute trails the
                # group's quorum decisions.  A permanently slower stick
                # under quorum=k accumulates real backlog — the pipeline
                # does not wait for it, but operators must see it lagging
                # rather than read its dispatch-time busy_s as >100%
                # utilization.
                "straggler_lag_s": [round(max(0.0, l.bfree_at - self.now), 6)
                                    for l in g.lanes]
                if g.mode == "broadcast" else None,
                "est_s": [round(l.est_s, 6) for l in g.lanes],
                "heterogeneous": len({(l.cart.device.name,
                                       l.cart.device.service_s)
                                      for l in g.lanes}) > 1,
                "processed": sum(l.stats.processed for l in g.lanes),
            }
        if self.profile_enabled:
            self._prof["bookkeeping_s"] += time.perf_counter() - t_book
            p = self._prof
            self.report.profile = _ProfileDict({
                "core": self.core,
                "dispatch_s": p["dispatch_s"],
                "service_s": p["service_s"],
                "control_s": p["control_s"],
                "bookkeeping_s": p["bookkeeping_s"],
                "events": dict(p["events"]),
            })
        return self.report

    # -- source ---------------------------------------------------------------
    def attach_frontdoor(self, fd: FrontDoor) -> FrontDoor:
        """Install the multi-tenant admission controller.  All frame
        sources flow through it from here on: ``feed()`` targets its
        default tenant, ``feed_tenant()`` any registered tenant.  The
        door paces off live fleet capacity (parked/throttled hubs and
        quarantined lanes shrink the credit pool — backpressure instead
        of ballooning queues)."""
        if self._fd is not None:
            raise RuntimeError("a front door is already attached")
        fd.bind(clock=lambda: self.now,
                schedule=lambda t, fn: self._push_event(t, fn),
                admit=self._admit_frame,
                capacity=self._capacity_fps,
                tracer=self._trace)
        self._fd = fd
        return fd

    def feed(self, n_frames: int, interval_s: float, payload_fn=None,
             frame_bytes: int = 150528, t0: float = 0.0):
        """Single-operator source: the single-default-tenant special case
        of ``feed_tenant`` (a trivial front door is attached lazily; its
        pass-through admission is bit-identical to direct ingest)."""
        if self._fd is None:
            self.attach_frontdoor(FrontDoor())
        self.feed_tenant(self._fd.default_tenant, n_frames, interval_s,
                         payload_fn=payload_fn, frame_bytes=frame_bytes,
                         t0=t0)

    def feed_tenant(self, tenant: str, n_frames: int, interval_s: float,
                    payload_fn=None, frame_bytes: int = 150528,
                    t0: float = 0.0):
        """Schedule ``n_frames`` arrivals for ``tenant``; each is offered
        to the front door at its arrival instant."""
        if self._fd is None:
            raise RuntimeError("no front door attached — construct the "
                               "engine with frontdoor=, or use feed()")
        if tenant not in self._fd.tenant_names:
            raise KeyError(f"unknown tenant {tenant!r}")
        for i in range(n_frames):
            self._push_event(t0 + i * interval_s, self._tenant_arrival,
                             tenant, payload_fn(i) if payload_fn else None,
                             frame_bytes)

    def _tenant_arrival(self, tenant: str, payload, frame_bytes):
        """One offered frame: tenant id rides the message end-to-end,
        and the SLO deadline (when the tenant has one) is stamped so the
        hedge machinery can spend the remaining budget."""
        meta = {"bytes": frame_bytes, "tenant": tenant}
        slo = self._fd.tenant(tenant).slo_s
        if slo is not None:
            meta["_slo_t"] = self.now + slo
        m = msg.Message(kind=msg.IMAGE_FRAME, seq=next(self._frame_seq),
                        payload=payload, t_created=self.now, meta=meta)
        self._fd.offer(tenant, m, self.now)

    def _frame_arrival(self, payload, frame_bytes):
        m = msg.Message(kind=msg.IMAGE_FRAME, seq=next(self._frame_seq),
                        payload=payload, t_created=self.now,
                        meta={"bytes": frame_bytes})
        self._admit_frame(m)

    def _admit_frame(self, m: msg.Message):
        """A frame passed admission (or arrived pre-door): count it,
        trace ingest, and dispatch — or hold-buffer during pauses.
        ``m.t_created`` is the offer time, so any front-door queue wait
        counts toward end-to-end latency and the tenant's SLO."""
        self.report.frames_in += 1
        if self._trace is not None and self._trace.admit(m.seq):
            self._trace.frame_begin(m.seq, self.now)
            args = {"bytes": m.meta.get("bytes", 0)}
            if "tenant" in m.meta:
                args["tenant"] = m.meta["tenant"]
            self._trace.instant(trc.INGEST, self.now, m.seq, track="source",
                                **args)
        if self.now < self.paused_until or self.halted_since is not None \
                or not self._groups:
            self._hold_buffer.append((0, m))  # paper: buffered, not dropped
            return
        self._enqueue(0, m)

    def _capacity_fps(self):
        """``(live_fps, nominal_fps)`` of the bottleneck stage — the
        front door's pacing signal.  Nominal counts every lane at its
        EWMA rate; live drops dead lanes and parked hubs, stretches
        throttled hubs by their duty inflation, and discounts lanes on
        quarantine probation — so admission shrinks with fleet health
        instead of letting queues balloon.  A paused or halted pipeline
        is live-zero: the door parks arrivals in bounded tenant queues
        rather than flooding the hold buffer."""
        halted = self.now < self.paused_until or self.halted_since is not None
        gov = self.governor if self.governor.active else None
        live_min = nom_min = float("inf")
        for g in self._groups:
            if not g.lanes:
                continue
            if g.mode == "broadcast":
                # barrier-paced: the group advances at the slowest replica
                nom = 1.0 / max(max(l.est_s for l in g.lanes), 1e-9)
                up = [l for l in g.lanes
                      if not (self._chaos and id(l) in self._down)
                      and not (gov is not None
                               and gov.parked(self.now, l.hub))]
                live = 0.0 if not up else \
                    1.0 / max(max(l.est_s for l in up), 1e-9)
            else:
                nom = live = 0.0
                for l in g.lanes:
                    r = 1.0 / max(l.est_s, 1e-9)
                    nom += r
                    if self._chaos and id(l) in self._down:
                        continue
                    if gov is not None:
                        if gov.parked(self.now, l.hub):
                            continue
                        r /= max(gov.inflation(self.now, l.hub), 1e-9)
                    if self._chaos:
                        r /= max(self.qledger.penalty(l.cart.name, self.now),
                                 1e-9)
                    live += r
            nom_min = min(nom_min, nom)
            live_min = min(live_min, live)
        if nom_min == float("inf"):
            return 0.0, 0.0
        # The shared bus is a serialized medium every hop crosses, and on
        # USB-class fabrics it — not the lanes — can be the bottleneck.
        # Hop count and payload sizes vary per pipeline, so it is measured
        # rather than modeled: amortized bus-busy seconds per delivered
        # frame is exact in the limit and independent of offered load.
        done = self.report.frames_out
        if done >= 8 and self.bus.busy_s > 0:
            bus_fps = done / self.bus.busy_s
            nom_min = min(nom_min, bus_fps)
            live_min = min(live_min, bus_fps)
        return (0.0 if halted else live_min), nom_min

    # -- stage machinery ------------------------------------------------------
    # Events reference _Lane/_LaneGroup objects, not indices: hot-swap
    # rebuilds the topology mid-flight, so positions are resolved at event
    # time and a message whose lane vanished is re-buffered (zero loss).
    def _enqueue(self, idx: int, m: msg.Message):
        if idx >= len(self._groups):
            self._complete(m)
            return
        g = self._groups[idx]
        m.meta["_t_stage"] = self.now      # per-stage latency breakdown
        if g.mode == "broadcast":
            m.meta.pop("_hub", None)
            g.bqueue.append(m)
            if self._trace is not None and self._trace.watches(m.seq):
                self._trace.instant(trc.DISPATCH, self.now, m.seq,
                                    track=g.name, stage=g.name,
                                    mode="broadcast", quorum=g.quorum)
            self._try_start_broadcast(g)
            return
        lane = g.pick_lane(self.now, weighted=self.dispatch == "ewma",
                           prefer_hub=m.meta.pop("_hub", None),
                           bank=self._pick_bank,
                           **self._pick_kwargs())
        if lane is None:
            # no live lane right now (all down/quarantined): buffer, zero
            # loss — reinstatement drains the hold buffer
            self._hold_buffer.append((idx, m))
            return
        if self._trace is not None and self._trace.watches(m.seq):
            self._trace_dispatch(g, lane, m)
        lane.queue.append(m)
        self._try_start_lane(lane)

    def _trace_dispatch(self, g, lane: _Lane, m: msg.Message):
        """DISPATCH instant carrying the argmin inputs that chose the
        lane — backlog, EWMA estimate, the resulting ETA, plus throttle
        inflation and probation toll when those hooks were active — so a
        frame's routing decision is auditable from the trace alone."""
        backlog = lane.backlog()
        args = {"stage": g.name, "lane": lane.cart.name, "hub": lane.hub,
                "backlog": backlog, "est_s": lane.est_s,
                "eta_s": (backlog + 1) * lane.est_s, "mode": g.mode}
        if self.governor.active:
            args["est_scale"] = self.governor.inflation(self.now, lane.hub)
        if self._chaos:
            args["probation_toll_s"] = self.qledger.penalty(
                lane.cart.name, self.now)
        self._trace.instant(trc.DISPATCH, self.now, m.seq,
                            track=lane.cart.name, **args)

    def _trace_service_begin(self, lane: _Lane, batch, b: int, infl: float):
        """Open one SERVICE span per traced frame in the cycle.  A lane
        runs at most one cycle at a time (busy flag), so the open sids
        key by lane identity; ``_lane_done`` / ``_fail_lane`` close
        them."""
        rec = self._trace
        gal = getattr(lane.cart, "gallery", None)
        if gal is not None and getattr(gal, "tracer", None) is None:
            gal.tracer = rec          # late-bound: carts attach post-init
        sids = None
        for m in batch:
            if rec.watches(m.seq):
                sid = rec.begin(trc.SERVICE, self.now, m.seq,
                                track=lane.cart.name, batch=b,
                                hub=lane.hub, infl=infl)
                if sids is None:
                    sids = []
                sids.append(sid)
        if sids is not None:
            self._svc_sids[id(lane)] = sids

    def _trace_service_end(self, lane: _Lane, status: str):
        """Close the lane's open SERVICE spans.  Completed match-stage
        cycles attach the gallery scan counters (rows_scored /
        scan_fraction) so ANN pruning is visible per frame."""
        sids = self._svc_sids.pop(id(lane), None)
        if sids is None:
            return
        rec = self._trace
        extra = {"status": status}
        gal = getattr(lane.cart, "gallery", None)
        if gal is not None:
            ms = getattr(gal, "last_match_stats", None)
            if ms:
                extra["rows_scored"] = ms.get("rows_scored")
                extra["scan_fraction"] = ms.get("scan_fraction")
                extra["match_mode"] = ms.get("mode")
        for sid in sids:
            rec.end(sid, self.now, **extra)

    def _trace_transfer(self, batch, done: float, nbytes: int,
                        src: Optional[int], dst: Optional[int], **extra):
        """Emit a (pre-closed) TRANSFER span per traced frame: arrival
        time is deterministic at schedule time, so no open/close pairing
        is needed.  On a fabric the per-leg breakdown (source egress /
        inter-hub link / destination ingress) rides along."""
        rec = self._trace
        watched = [m for m in batch if rec.watches(m.seq)]
        if not watched:
            return
        if src is None and dst is None:
            track = "bus"
        else:
            # mirror the router's collapse rule: a missing side is a
            # host-local leg on the other's hub (``FabricRouter._route``)
            s = src if src is not None else dst
            d = dst if dst is not None else s
            track = f"hub{s}->hub{d}" if s != d else f"hub{s}"
        args = {"bytes": nbytes, **extra}
        if self.fabric is not None:
            legs = self.fabric.route_legs(src, dst, nbytes)
            if legs:
                args.update(legs)
        for m in watched:
            rec.span(trc.TRANSFER, self.now, done, m.seq, track=track,
                     **args)

    def _serviced_orphan_target(self, slot: int, pos: int) -> int:
        """Where an already-serviced message of a vanished lane/group goes:
        past its slot's current position if the slot still exists, else the
        old position (which the downstream neighbor shifted into)."""
        if slot in self._slot_index:
            return self._slot_index[slot] + 1
        return pos

    def _reinject(self, pos: int, m: msg.Message):
        """Put an orphaned in-flight message back into the pipeline at the
        slot that shifted into its old position.  During a pause/halt it
        waits in the hold buffer (drained by ``_resume``); otherwise — e.g.
        after a pauseless replica detach — it re-enters immediately."""
        if self.now < self.paused_until or self.halted_since is not None \
                or not self._groups:
            self._hold_buffer.append((pos, m))
            return
        self._enqueue(min(pos, len(self._groups)), m)

    def _service_time(self, lane: _Lane, b: int, seq: int):
        """Batch service time on a lane, with deterministic heavy-tail
        jitter (stall multiplier drawn from a hash of lane identity and the
        leading frame's seq).  Returns (svc, batch_factor) so callers can
        recover the batch-normalized per-cycle cost ``svc / factor``."""
        dev = lane.cart.device
        factor = 1.0 + (b - 1) * dev.batch_marginal
        svc = dev.service_s * factor
        if dev.jitter_p > 0.0:
            u = zlib.crc32(f"{lane.cart.name}:{seq}".encode()) / 0xFFFFFFFF
            if u < dev.jitter_p:
                svc *= dev.jitter_mult
        return svc, factor

    def _try_start_lane(self, lane: _Lane):
        g = self._group_of_lane(lane)
        if g is None or self.halted_since is not None:
            return
        if self._chaos and id(lane) in self._down:
            return                           # quarantined: no new cycles
        if lane.busy or lane.held is not None or not lane.queue:
            return
        if self.now < self.paused_until:
            self._push_event(self.paused_until, self._try_start_lane, lane)
            return
        if lane.ready_at > self.now:         # replica still handshaking
            self._push_event(lane.ready_at, self._try_start_lane, lane)
            return
        if self.governor.active and self.governor.parked(self.now, lane.hub):
            # hub over its watt budget even throttled: no new cycles until
            # the draw estimate cools.  The governor's closed-form decay
            # gives the recheck time; queued frames wait (zero loss).  One
            # pending retry per lane — a deep queue must not multiply
            # identical wake-ups every park interval.
            if not lane.parked_wait:
                lane.parked_wait = True
                eta = self.governor.unpark_eta(self.now, lane.hub)
                self._push_event(max(eta, self.now + 1e-3),
                                 self._unpark_retry, lane)
            return
        # throttled hub: the cycle is duty-stretched (the stretch is forced
        # idle — the compute itself is unchanged, so est_s/svc_hist keep
        # learning the *device*, and dispatch sees the stretch via
        # est_scale instead of a poisoned EWMA)
        infl = self.governor.inflation(self.now, lane.hub) \
            if self.governor.active else 1.0
        # adaptive micro-batch: drain the backlog in one service cycle.
        # Under throttle the batch is capped so one duty-stretched cycle
        # commits at most half the thermal horizon of draw — otherwise a
        # single stretched 8-frame cycle outlives the control period and
        # the governor can only watch the budget sail by.
        b = 1
        if self.microbatch and len(lane.queue) >= 2:
            b = min(len(lane.queue), self.queue_cap)
            if infl > 1.0:
                dev = lane.cart.device
                room = 0.5 * self.governor.tau_of(lane.hub) / \
                    max(dev.service_s * infl, 1e-12)
                b_cap = 1 + int(max(room - 1.0, 0.0) /
                                max(dev.batch_marginal, 1e-6))
                b = max(1, min(b, b_cap))
        batch = [lane.queue.popleft() for _ in range(b)]
        lane.set_busy(True)
        svc, factor = self._service_time(lane, b, batch[0].seq)
        dur = svc * infl if infl != 1.0 else svc
        if self.hedge and g.mode == "shard" and len(g.lanes) > 1:
            self._arm_hedges(g, lane, batch, factor, infl)
        if self.execute_payloads:
            # one dispatch per micro-batch: match-type stages coalesce the
            # whole batch into a single kernel call (Cartridge.process_batch)
            batch = lane.cart.process_batch(batch)
        self.health.start_request(lane.cart.name, batch[0].seq, self.now)
        lane.stats.busy_s += dur
        lane.stats.batches += 1
        lane.stats.max_batch = max(lane.stats.max_batch, b)
        self.governor.on_cycle_start(self.now, lane.cart, dur, svc)
        if self._trace is not None:
            self._trace_service_begin(lane, batch, b, infl)
        handle = self._push_event(self.now + dur, self._lane_done, lane,
                                  batch, svc / factor)
        if self._chaos:
            # remember the cycle so a crash can cancel it and recover the
            # batch; arm the watchdog that promotes a hang into a failure
            lane.cycle_seq += 1
            lane.inflight = (handle, batch)
            if lane.hang_next:
                lane.hang_next = False       # the service never completes
                self._events.cancel(handle)
            lane.wd_handle = self._push_event(
                self.now + max(self._watchdog_deadline(lane, factor) * infl,
                               dur + 1e-6),
                self._watchdog_fire, lane, lane.cycle_seq)

    def _unpark_retry(self, lane: _Lane):
        lane.parked_wait = False
        self._try_start_lane(lane)

    # -- hedged dispatch (tied requests over shard lanes) ---------------------
    def _hedge_deadline(self, lane: _Lane, factor: float) -> float:
        """Adaptive deadline for one service cycle: a quantile of the
        lane's own observed (batch-normalized) service distribution, with
        a margin so a typical cycle never triggers; before enough
        observations exist, fall back to the health monitor's straggler
        factor over the EWMA estimate."""
        h = lane.svc_hist
        if h.count >= self.hedge_min_obs:
            base = max(h.quantile(self.hedge_quantile), lane.est_s)
        else:
            base = lane.est_s * self.health.straggler_factor
        return base * factor * self.hedge_margin

    def _arm_hedges(self, g: _LaneGroup, lane: _Lane, batch: list,
                    factor: float, infl: float = 1.0):
        """Register hedge tasks for every first-copy message entering
        service, sharing one deadline event per cycle (they finish
        together, so they stall together).  ``infl`` scales the deadline
        by the hub's throttle stretch: a duty-cycled lane is slow by
        decree, not stalling."""
        fresh = [m for m in batch
                 if (lane.slot, m.seq) not in self._hedges]
        if not fresh:
            return
        deadline = self._hedge_deadline(lane, factor) * infl
        if self._fd is not None and self._fd.has_slo:
            # SLO-driven hedging: spend at most half the tightest
            # remaining per-tenant budget waiting on a straggler, but
            # never hedge inside a single expected service time (a
            # blown deadline is already lost; a zero-delay hedge storm
            # would finish the job)
            cap = None
            for m in fresh:
                s = m.meta.get("_slo_t")
                if s is not None and (cap is None or s < cap):
                    cap = s
            if cap is not None:
                room = (cap - self.now) * self.slo_hedge_frac
                if room < deadline:
                    deadline = max(room, lane.est_s * factor * infl)
        handle = self._push_event(self.now + deadline, self._hedge_check,
                                  g, lane, tuple(m.seq for m in fresh))
        for m in fresh:
            self._hedges[(lane.slot, m.seq)] = _HedgeTask(
                m.seq, m, lane, handle)

    def _hedge_check(self, g: _LaneGroup, lane: _Lane, seqs: tuple):
        """Deadline fired before the primary finished: speculatively
        re-enqueue each still-undecided message on the best alternate
        lane.  First completion wins (``_filter_hedged``).  The stalled
        lane's *queued* frames haven't started anywhere, so they migrate
        to healthy lanes outright — rebalancing, not speculation."""
        if self._group_by_slot.get(g.slot) is not g:
            return                          # group left the chain mid-wait
        stalled = False
        for seq in seqs:
            task = self._hedges.get((g.slot, seq))
            if task is None or task.winner is not None \
                    or task.backup is not None:
                continue
            stalled = True
            alt = g.pick_lane(self.now, weighted=self.dispatch == "ewma",
                              exclude=task.primary, bank=self._pick_bank,
                              **self._pick_kwargs())
            if alt is None or len(alt.queue) >= self.queue_cap:
                continue                    # no headroom to speculate into
            task.check_handle = None
            task.backup = alt
            task.copies += 1
            copy = dataclasses.replace(
                task.message,
                meta=dict(task.message.meta, _hedge_copy=True))
            self.report.hedges["issued"] += 1
            self.health.record_backup(task.primary.cart.name, self.now, seq)
            if self._trace is not None and self._trace.watches(seq):
                self._trace.instant(
                    trc.HEDGE_FORK, self.now, seq, track=alt.cart.name,
                    primary=task.primary.cart.name, backup=alt.cart.name,
                    stalled_s=self.now - task.message.meta.get(
                        "_t_stage", self.now),
                    cross_hub=self.fabric is not None
                    and alt.hub != task.primary.hub)
            if self.fabric is not None and alt.hub != task.primary.hub:
                # the speculative copy must cross to the backup's hub.  It
                # is charged ingress-only to the *destination* hub's bus
                # (the host re-sends from its own buffer: no source-hub
                # egress, no inter-hub link), so speculation never erodes
                # the source hub's arbitration budget.  The copy only
                # becomes runnable once that transfer lands.
                self.report.hedges["cross_hub"] += 1
                done = self.fabric.transfer(
                    self.now, self._msg_bytes(copy),
                    self._n_endpoints(alt.hub), src=None, dst=alt.hub)
                if self._trace is not None and self._trace.watches(seq):
                    self._trace.span(
                        trc.TRANSFER, self.now, done, seq,
                        track=f"host->hub{alt.hub}",
                        bytes=self._msg_bytes(copy), hedge_copy=True)
                self._push_event(done, self._hedge_copy_arrive,
                                 task, alt, copy)
            else:
                alt.queue.append(copy)
                self._try_start_lane(alt)
        if stalled and id(lane) in g.lane_ids:
            self._migrate_queue(g, lane)

    def _hedge_copy_arrive(self, task: _HedgeTask, alt: _Lane,
                           copy: msg.Message):
        """A cross-hub speculative copy finished its ingress transfer.  If
        the race resolved, the backup lane unplugged, or the lane's queue
        filled while it was on the wire, drop it at the hub boundary — it
        was never queued, so exactly-once needs only the copy count
        decrement."""
        if task.winner is not None or task.backup is not alt \
                or self._group_of_lane(alt) is None \
                or len(alt.queue) >= self.queue_cap:
            task.copies -= 1
            if task.backup is alt:
                task.backup = None
            if task.copies <= 0:
                self._hedges.pop((task.primary.slot, task.seq), None)
            self.report.hedges["dropped_in_flight"] += 1
            return
        alt.queue.append(copy)
        self._try_start_lane(alt)

    def _migrate_queue(self, g: _LaneGroup, lane: _Lane):
        """Move a presumed-stalled lane's unstarted backlog to its peers.
        Backup copies parked here stay put (their primary is live
        elsewhere); everything else re-lands on the best alternate lane
        with headroom.  On a fabric, migrating to a lane on another hub
        is a real host re-send: like hedge copies it is charged
        ingress-only to the *destination* hub's bus, and the frame only
        becomes runnable there once the transfer lands — no free
        cross-hub moves."""
        if not lane.queue:
            return
        keep: deque = deque()
        weighted = self.dispatch == "ewma"
        gov_kw = self._pick_kwargs()
        for m in lane.queue:
            if m.meta.get("_hedge_copy"):
                keep.append(m)
                continue
            alt = g.pick_lane(self.now, weighted=weighted, exclude=lane,
                              bank=self._pick_bank, **gov_kw)
            if alt is None or len(alt.queue) >= self.queue_cap:
                keep.append(m)
                continue
            self.report.hedges["migrated"] += 1
            if self.fabric is not None and alt.hub != lane.hub:
                done = self.fabric.transfer(
                    self.now, self._msg_bytes(m),
                    self._n_endpoints(alt.hub), src=None, dst=alt.hub)
                self._push_event(done, self._migrate_arrive, alt, m)
                continue
            alt.queue.append(m)
            self._try_start_lane(alt)
        lane.reset_queue(keep)

    def _migrate_arrive(self, alt: _Lane, m: msg.Message):
        """A migrated frame finished crossing to the healthy lane's hub.
        Unlike a hedge copy it is the frame's ONLY live instance, so if
        the target vanished or filled while it was on the wire it
        re-enters the pipeline (zero loss) instead of being dropped."""
        if self._group_of_lane(alt) is not None \
                and len(alt.queue) < self.queue_cap:
            alt.queue.append(m)
            self._try_start_lane(alt)
            return
        self._reinject(self._slot_index.get(alt.slot, alt.pos), m)

    def _cancel_queued_copy(self, lane: _Lane, seq: int) -> bool:
        for m in lane.queue:
            if m.seq == seq and m.meta.get("_hedge_copy"):
                lane.queue.remove(m)
                return True
        return False

    def _filter_hedged(self, lane: _Lane, batch: list) -> list:
        """Resolve hedge races for a completed service cycle.  Returns the
        messages this lane may deliver downstream: first copy home wins,
        every other copy is cancelled (queued) or suppressed (serviced) —
        delivery is exactly-once by construction."""
        deliver = []
        slot = lane.slot
        for m in batch:
            task = self._hedges.get((slot, m.seq))
            if task is None:
                deliver.append(m)
                continue
            if task.winner is None:
                task.winner = lane
                if task.check_handle is not None:
                    self._events.cancel(task.check_handle)
                    task.check_handle = None
                if lane is task.backup:
                    self.report.hedges["won_by_backup"] += 1
                task.copies -= 1            # the winning copy exits
                loser = task.primary if lane is task.backup else task.backup
                if task.copies > 0 and loser is not None and \
                        self._cancel_queued_copy(loser, m.seq):
                    task.copies -= 1
                    self.report.hedges["cancelled_queued"] += 1
                if task.copies <= 0:
                    del self._hedges[(slot, m.seq)]
                m.meta.pop("_hedge_copy", None)
                if self._trace is not None and self._trace.watches(m.seq):
                    self._trace.instant(
                        trc.HEDGE_WIN, self.now, m.seq,
                        track=lane.cart.name, winner=lane.cart.name,
                        won_by_backup=lane is task.backup)
                deliver.append(m)
            else:
                # this copy lost the race after being serviced: its result
                # never crosses the bus (suppressed handoff).  On a fabric
                # the suppression happens at the router, before the
                # inter-hub leg starts — saving link + destination-hub
                # time, not just the local egress.
                task.copies -= 1
                if task.copies <= 0:
                    del self._hedges[(slot, m.seq)]
                self.report.hedges["wasted"] += 1
                if self._trace is not None and self._trace.watches(m.seq):
                    self._trace.instant(
                        trc.HEDGE_LOSS, self.now, m.seq,
                        track=lane.cart.name, loser=lane.cart.name,
                        suppressed=True)
                if self.fabric is not None:
                    g2 = self._group_by_slot.get(slot)
                    dst = self._route_hub(g2.pos + 1, src_hub=lane.hub,
                                          nbytes=self._msg_bytes(m)) \
                        if g2 is not None else None
                    if dst is _BLOCKED:     # nothing reachable to save:
                        dst = None          # book the local egress only
                    self.fabric.suppress(
                        self._msg_bytes(m), src=lane.hub, dst=dst,
                        t=self.now, n_endpoints=self._n_endpoints(lane.hub),
                        dst_endpoints=self._n_endpoints(dst)
                        if dst is not None else 1)
                else:
                    self.bus.suppress(self._msg_bytes(m))
        return deliver

    def _lane_done(self, lane: _Lane, batch: list, svc_norm: float = 0.0):
        if self._chaos:
            lane.inflight = None
            if lane.wd_handle is not None:   # cycle completed: disarm
                self._events.cancel(lane.wd_handle)
                lane.wd_handle = None
        lane.stats.processed += len(batch)
        lane.set_busy(False)
        self.governor.on_cycle_end(self.now, lane.cart)
        if svc_norm > 0.0:
            lane.observe(svc_norm, self.ewma_alpha)
        self.health.finish_request(lane.cart.name, self.now)
        if self._trace is not None:
            self._trace_service_end(lane, status="ok")
        deliver = self._filter_hedged(lane, batch) if self._hedges else batch
        if not deliver:                     # whole cycle lost its races
            self._try_start_lane(lane)
            return
        g = self._group_of_lane(lane)
        name = g.name if g is not None else lane.cart.name
        hist = self.report.stage_hist.get(name)
        if hist is None:
            hist = self.report.stage_hist[name] = StreamingHistogram()
        if len(deliver) > 1:
            # bulk ingest for micro-batched cycles: one vectorized bin
            # pass (bin counts bit-identical to per-sample record)
            now = self.now
            hist.record_many([now - m.meta.get("_t_stage", now)
                              for m in deliver])
        else:
            hist.record(self.now - deliver[0].meta.get("_t_stage", self.now))
        self._handoff(lane, deliver)

    def _handoff(self, lane: _Lane, batch: list):
        """Bus transfer of a (micro-)batch to the next group, honoring
        backpressure."""
        g = self._group_of_lane(lane)
        if g is None:
            # lane removed mid-flight: the batch is already serviced, so it
            # re-enters downstream — at pos+1 while the slot survives
            # (replica detach), or at the old pos when the whole slot
            # vanished (the next stage shifted into the gap)
            tgt = self._serviced_orphan_target(lane.slot, lane.pos)
            for m in batch:
                self._reinject(tgt, m)
            return
        nxt = g.pos + 1
        if nxt < len(self._groups) and \
                self._groups[nxt].free_capacity(self._pick_bank) \
                < len(batch):
            # downstream full: hold (upstream throttles automatically since
            # this lane won't start its next frame while holding)
            lane.set_held(batch)
            self._push_event(self.now + 1e-3, self._retry_handoff, lane)
            return
        nbytes = sum(self._msg_bytes(m) for m in batch)
        if self.fabric is not None:
            # host-side routing: egress on the source hub, inter-hub link,
            # ingress on the routed destination hub (local legs collapse).
            # The pre-route decision is fabric-aware: it charges each
            # candidate lane the current cost of the route to its hub.
            dst_hub = self._route_hub(nxt, src_hub=lane.hub, nbytes=nbytes)
            if dst_hub is _BLOCKED:
                # every destination lane is down or unreachable over the
                # surviving links: hold the serviced batch at the source
                # and re-probe the route with backoff (zero loss — link
                # restore or lane reinstatement unblocks it)
                self.report.faults["reroute_blocked"] += 1
                lane.set_held(batch)
                m0 = batch[0]
                attempt = m0.meta.get("_retries", 0)
                m0.meta["_retries"] = attempt + 1
                self._note_retry(m0)
                self._push_event(
                    self.now + self.retry.backoff(attempt,
                                                  key=f"route:{m0.seq}"),
                    self._retry_handoff, lane)
                return
            done = self.fabric.transfer(
                self.now, nbytes, self._n_endpoints(lane.hub),
                src=lane.hub, dst=dst_hub,
                dst_endpoints=self._n_endpoints(dst_hub)
                if dst_hub is not None else 1)
            if dst_hub is not None:
                for m in batch:     # arrival should land on the paid-for
                    m.meta["_hub"] = dst_hub    # hub (local routes too —
                    # a silent hub switch at arrival would be a free
                    # cross-hub move the router never charged)
        else:
            done = self.bus.transfer(self.now, nbytes, self._n_endpoints())
        if self._trace is not None:
            self._trace_transfer(
                batch, done, nbytes,
                src=lane.hub if self.fabric is not None else None,
                dst=dst_hub if self.fabric is not None else None)
        nxt_group = self._groups[nxt] if nxt < len(self._groups) else None
        self._send_batch(done, lane.hub if self.fabric is not None else None,
                         nxt_group, batch)
        self._try_start_lane(lane)

    @staticmethod
    def _msg_bytes(m: msg.Message) -> int:
        return m.meta.get("bytes", m.nbytes() if m.payload is not None else 0)

    def _retry_handoff(self, lane: _Lane):
        if lane.held is None:
            return
        batch = lane.held
        lane.set_held(None)
        lane.stats.blocked_s += 1e-3
        self._handoff(lane, batch)

    def _arrive_next(self, nxt_group: Optional[_LaneGroup], batch: list):
        if nxt_group is None:               # sink: results reached the host
            for m in batch:
                self._complete(m)
            return
        if id(nxt_group) not in self._live_groups:
            # target vanished between transfer start and arrival
            for m in batch:
                self._reinject(nxt_group.pos, m)
            return
        for m in batch:
            self._enqueue(nxt_group.pos, m)

    def _complete(self, m: msg.Message):
        if self._chaos:
            # exactly-once audit: every recovery path must deliver each
            # frame once.  A duplicate is counted (and the chaos bench
            # fails on it), never silently dropped — masking a recovery
            # bug would be worse than double delivery.
            if m.seq in self._delivered:
                self.report.faults["duplicates"] += 1
            else:
                self._delivered.add(m.seq)
        self.report.frames_out += 1
        self.report.last_out_t = self.now
        lat = self.now - m.t_created
        self.report.latencies.append(lat)
        self.report.latency_hist.record(lat)
        if self._fd is not None:
            tenant = m.meta.get("tenant")
            if tenant is not None:
                self._fd.on_complete(tenant, lat, self.now)
        if self._trace is not None and self._trace.watches(m.seq):
            self._trace.instant(trc.COMPLETE, self.now, m.seq, track="sink",
                                latency_s=lat)
            self._trace.frame_end(m.seq, self.now, latency_s=lat)

    # -- broadcast lanes (paper §4.1, Table 1) --------------------------------
    def _try_start_broadcast(self, g: _LaneGroup):
        if id(g) not in self._live_groups or self.halted_since is not None:
            return
        if g.bbusy or g.bheld is not None or not g.bqueue:
            return
        if self.now < self.paused_until:
            self._push_event(self.paused_until, self._try_start_broadcast, g)
            return
        pool = g.lanes
        if self._chaos and self._down:
            pool = [l for l in pool if id(l) not in self._down]
            if not pool:
                # every replica is down: the frame waits in bqueue and
                # reinstatement re-kicks the group (zero loss)
                return
        lanes = [l for l in pool if l.ready_at <= self.now]
        if not lanes:
            self._push_event(min(l.ready_at for l in pool),
                             self._try_start_broadcast, g)
            return
        m = g.bqueue.popleft()
        g.bbusy = True
        if self.execute_payloads and m.payload is not None:
            m = lanes[0].cart.process(m)   # replicas compute identically
        nbytes = self._msg_bytes(m)
        finishes = []
        for lane in lanes:
            if self.fabric is not None:
                # host fan-out: each replica's copy is charged ingress on
                # its own hub (per-hub arbitration domain)
                arr = self.fabric.transfer(
                    self.now, nbytes, self._n_endpoints(lane.hub),
                    src=None, dst=lane.hub)
            else:
                arr = self.bus.transfer(self.now, nbytes,
                                        self._n_endpoints())
            svc, _ = self._service_time(lane, 1, m.seq)
            # broadcast lanes are barrier-paced, so a watt budget applies
            # feed-forward (population duty, no EWMA feedback); with no
            # budget the stretch is exactly 1.0 — Table 1 is bit-identical
            binfl = self.governor.duty_inflation(self.now, lane.hub) \
                if self.governor.active else 1.0
            dur = svc * binfl if binfl != 1.0 else svc
            lane.stats.busy_s += dur
            lane.stats.processed += 1
            lane.stats.batches += 1
            lane.stats.max_batch = max(lane.stats.max_batch, 1)
            self.governor.on_window(self.now, lane.cart, dur, svc)
            # a replica cannot start this frame while still computing the
            # previous one: under a quorum decision a straggler works off
            # its own backlog instead of being >100% utilized.  With the
            # full barrier (quorum=N) every lane finished before the next
            # dispatch, so the gate is a no-op and Table 1 is untouched.
            finish = max(arr, lane.bfree_at) + dur
            lane.bfree_at = finish
            finishes.append(finish)
            if self._trace is not None and self._trace.watches(m.seq):
                self._trace.span(trc.TRANSFER, self.now, arr, m.seq,
                                 track=lane.cart.name, bytes=nbytes,
                                 broadcast=True)
                self._trace.span(trc.SERVICE, finish - dur, finish, m.seq,
                                 track=lane.cart.name, hub=lane.hub,
                                 broadcast=True, status="ok")
        # quorum: the frame is decided at the k-th replica completion
        # (k = N, the default, is Table 1's full barrier — exactly
        # max(finishes)).  Stragglers keep computing (busy time already
        # charged) but their result handoffs are suppressed — exactly
        # N-k of them by rank, not by comparing against the decision
        # time: on symmetric multi-hub fabrics finishes tie exactly, and
        # a tie is still a loser (only k results are fetched).
        k = min(g.quorum or len(finishes), len(finishes))
        order = sorted(range(len(finishes)), key=finishes.__getitem__)
        decide = finishes[order[k - 1]]
        for i in order[k:]:
            if self.fabric is not None:
                self.fabric.suppress(BROADCAST_RESULT_BYTES,
                                     src=lanes[i].hub, t=self.now,
                                     n_endpoints=self._n_endpoints(
                                         lanes[i].hub))
            else:
                self.bus.suppress(BROADCAST_RESULT_BYTES)
        self._push_event(decide, self._broadcast_done, g, m)

    def _broadcast_done(self, g: _LaneGroup, m: msg.Message):
        g.bbusy = False
        hist = self.report.stage_hist.get(g.name)
        if hist is None:
            hist = self.report.stage_hist[g.name] = StreamingHistogram()
        hist.record(self.now - m.meta.get("_t_stage", self.now))
        self._broadcast_handoff(g, m)

    def _broadcast_handoff(self, g: _LaneGroup, m: msg.Message):
        if id(g) not in self._live_groups:
            self._reinject(self._serviced_orphan_target(g.slot, g.pos), m)
            return
        nxt = g.pos + 1
        if nxt >= len(self._groups):
            # broadcast results (a few score bytes per replica) are fetched
            # during the NEXT frame's compute window — the §4.1 FPS
            # measurement does not charge them to the cycle
            self._complete(m)
            self._try_start_broadcast(g)
            return
        if self._groups[nxt].free_capacity(self._pick_bank) < 1:
            g.bheld = m
            self._push_event(self.now + 1e-3, self._retry_broadcast, g)
            return
        src = None
        if self.fabric is not None:
            src = g.lanes[0].hub if g.lanes else None
            dst_hub = self._route_hub(nxt, src_hub=src,
                                      nbytes=self._msg_bytes(m))
            if dst_hub is _BLOCKED:
                self.report.faults["reroute_blocked"] += 1
                g.bheld = m
                attempt = m.meta.get("_retries", 0)
                m.meta["_retries"] = attempt + 1
                self._note_retry(m)
                self._push_event(
                    self.now + self.retry.backoff(attempt,
                                                  key=f"route:{m.seq}"),
                    self._retry_broadcast, g)
                return
            done = self.fabric.transfer(
                self.now, self._msg_bytes(m),
                self._n_endpoints(src) if src is not None else 1,
                src=src, dst=dst_hub,
                dst_endpoints=self._n_endpoints(dst_hub)
                if dst_hub is not None else 1)
            if dst_hub is not None:
                m.meta["_hub"] = dst_hub
        else:
            done = self.bus.transfer(self.now, self._msg_bytes(m),
                                     self._n_endpoints())
        if self._trace is not None:
            self._trace_transfer(
                [m], done, self._msg_bytes(m), src=src,
                dst=dst_hub if self.fabric is not None else None)
        self._send_batch(done, src, self._groups[nxt], [m])
        self._try_start_broadcast(g)

    def _retry_broadcast(self, g: _LaneGroup):
        if g.bheld is None:
            return
        m, g.bheld = g.bheld, None
        self._broadcast_handoff(g, m)

    # -- chaos fabric (fault injection + recovery) ----------------------------
    # Every branch below is gated on self._chaos, which only a non-empty
    # FaultPlan sets: a fault-free engine pushes exactly the same events
    # in exactly the same order as before this subsystem existed, so
    # Table 1 (and every committed BENCH headline) stays bit-identical.

    def install_fault_plan(self, plan: FaultPlan):
        """Arm a fault plan: schedules its events into the engine queue
        and enables the recovery machinery.  Call before ``run`` (the
        usual path is the ``fault_plan=`` constructor argument)."""
        self.faults = plan
        if plan.empty:
            return
        self._chaos = True
        if self._trace is not None:
            self._trace.instant("fault.plan", self.now, track="faults",
                                **plan.describe())
        for ev in plan.events:
            self._push_event(ev.t, self._fault_event, ev)

    def _note_retry(self, m: msg.Message):
        """Book one retry against a frame's budget.  The budget never
        drops the frame (zero loss is the contract) — exhausting it
        raises an operator alert so pathological cells are visible."""
        self.report.faults["retries"] += 1
        if self._trace is not None and self._trace.watches(m.seq):
            self._trace.instant(trc.RETRY, self.now, m.seq,
                                attempt=m.meta.get("_retries", 0))
        if m.meta.get("_retries", 0) == self.retry.budget + 1:
            self.report.faults["budget_exhausted"] += 1
            self.report.alerts.append(
                (self.now, f"frame {m.seq}: retry budget "
                           f"({self.retry.budget}) exhausted; still "
                           f"retrying with capped backoff"))

    def _retry_dispatch(self, pos: int, m: msg.Message):
        """Re-dispatch a recovered frame with exponential backoff +
        deterministic jitter (keyed on the frame, so replays agree)."""
        attempt = m.meta.get("_retries", 0)
        m.meta["_retries"] = attempt + 1
        self._note_retry(m)
        self._push_event(
            self.now + self.retry.backoff(attempt, key=str(m.seq)),
            self._reinject, pos, m)

    # .. transfer integrity (frame checksum on bus handoffs) ..................
    def _send_batch(self, done: float, src_hub: Optional[int],
                    nxt_group: Optional[_LaneGroup], batch: list):
        """Schedule a transferred batch's arrival.  Fault-free (or with a
        zero corruption rate) this is exactly the old direct
        ``_arrive_next`` push; under a corruption rate each frame is
        stamped with a checksum and the arrival verifies it."""
        if not self._chaos or self.faults.corrupt_p <= 0.0:
            self._push_event(done, self._arrive_next, nxt_group, batch)
            return
        for m in batch:
            m.meta["_csum"] = frame_checksum(m)
        m0 = batch[0]
        xmit = m0.meta.get("_xmit", 0)
        m0.meta["_xmit"] = xmit + 1
        if self.faults.corrupt_draw(m0.seq, xmit):
            m0.meta["_csum"] ^= 1           # wire bit-flip
        self._push_event(done, self._arrive_checked, src_hub, nxt_group,
                         batch)

    def _arrive_checked(self, src_hub: Optional[int],
                        nxt_group: Optional[_LaneGroup], batch: list):
        """Receiver-side checksum verification: a clean batch proceeds,
        a corrupted one is re-sent from the host's source-side buffer
        after a backoff (detection signal: checksum mismatch; recovery:
        bounded re-send; the frame is never delivered corrupted)."""
        clean = all(m.meta.pop("_csum", None) == frame_checksum(m)
                    for m in batch)
        if clean:
            self._arrive_next(nxt_group, batch)
            return
        for m in batch:
            m.meta.pop("_csum", None)       # strip survivors' stale stamps
        self.report.faults["corrupt_detected"] += 1
        m0 = batch[0]
        if self._trace is not None and self._trace.watches(m0.seq):
            self._trace.instant(trc.CORRUPT, self.now, m0.seq,
                                xmit=m0.meta.get("_xmit", 0))
        attempt = m0.meta.get("_retries", 0)
        m0.meta["_retries"] = attempt + 1
        self._note_retry(m0)
        self._push_event(
            self.now + self.retry.backoff(attempt, key=f"csum:{m0.seq}"),
            self._resend_batch, src_hub, nxt_group, batch)

    def _resend_batch(self, src_hub: Optional[int],
                      nxt_group: Optional[_LaneGroup], batch: list):
        """Re-send a corrupted batch over the same route (the host still
        holds the source-side buffer).  If the route's link died in the
        meantime, wait it out with backoff — restore unblocks it."""
        nbytes = sum(self._msg_bytes(m) for m in batch)
        dst_hub = batch[0].meta.get("_hub")
        if self.fabric is not None:
            if not self.fabric.link_ok(src_hub, dst_hub):
                self.report.faults["reroute_blocked"] += 1
                m0 = batch[0]
                attempt = m0.meta.get("_retries", 0)
                m0.meta["_retries"] = attempt + 1
                self._note_retry(m0)
                self._push_event(
                    self.now + self.retry.backoff(attempt,
                                                  key=f"resend:{m0.seq}"),
                    self._resend_batch, src_hub, nxt_group, batch)
                return
            done = self.fabric.transfer(
                self.now, nbytes,
                self._n_endpoints(src_hub) if src_hub is not None else 1,
                src=src_hub, dst=dst_hub,
                dst_endpoints=self._n_endpoints(dst_hub)
                if dst_hub is not None else 1)
        else:
            done = self.bus.transfer(self.now, nbytes, self._n_endpoints())
        self.report.faults["resends"] += 1
        if self._trace is not None:
            for m in batch:
                if self._trace.watches(m.seq):
                    self._trace.instant(trc.RESEND, self.now, m.seq)
            self._trace_transfer(batch, done, nbytes, src=src_hub,
                                 dst=dst_hub, resend=True)
        self._send_batch(done, src_hub, nxt_group, batch)

    # .. watchdog (timeout promotion of hangs into failures) ..................
    def _watchdog_deadline(self, lane: _Lane, factor: float) -> float:
        """How long a cycle may run before a hang is declared: the hedge
        machinery's own service histogram quantile (p99 of the lane's
        observed batch-normalized service time) with a wide margin, so a
        jittery-but-alive cycle never trips it; cold lanes fall back to
        the straggler factor over the EWMA estimate."""
        h = lane.svc_hist
        if h.count >= self.hedge_min_obs:
            base = max(h.quantile(0.99), lane.est_s)
        else:
            base = lane.est_s * max(self.health.straggler_factor, 1.0)
        return base * factor * self.watchdog_margin

    def _watchdog_fire(self, lane: _Lane, cycle: int):
        """The service cycle outlived its deadline: promote the hang into
        a failure — same recovery as a crash (the device may be wedged in
        a way only a power cycle fixes)."""
        lane.wd_handle = None
        if not self._chaos or not lane.busy or lane.cycle_seq != cycle:
            return
        if self._group_of_lane(lane) is None or id(lane) in self._down:
            return
        self.report.faults["hang_promoted"] += 1
        if self._trace is not None:
            self._trace.instant(trc.WATCHDOG, self.now,
                                track=lane.cart.name, cycle=cycle)
        self._fail_lane(lane, "hang promoted by watchdog")

    # .. fault events ..........................................................
    def _fault_event(self, ev: flt.FaultEvent):
        self.report.faults["injected"] += 1
        if self._trace is not None:
            self._trace.instant(trc.FAULT, self.now, track="faults",
                                **ev.describe())
        if ev.kind == flt.LANE_CRASH:
            lane = self._find_lane(ev.target)
            if lane is not None and id(lane) not in self._down:
                self.report.faults["lane_crash"] += 1
                self._fail_lane(lane, "crash", min_lease_s=ev.duration)
        elif ev.kind == flt.LANE_HANG:
            lane = self._find_lane(ev.target)
            if lane is not None and id(lane) not in self._down:
                self.report.faults["lane_hang"] += 1
                if lane.busy and lane.inflight is not None:
                    # the in-service cycle silently never completes; the
                    # watchdog armed with it will promote the hang
                    self._events.cancel(lane.inflight[0])
                else:
                    lane.hang_next = True    # idle: the next cycle hangs
        elif ev.kind == flt.HUB_POWER_LOSS:
            hub = int(ev.target)
            victims = [l for l in self._lane_by_cart.values()
                       if l.hub == hub and id(l) not in self._down]
            if victims:
                self.report.faults["hub_power_loss"] += 1
                self.report.alerts.append(
                    (self.now, f"hub {ev.target} power loss "
                               f"({len(victims)} lanes)"))
                for lane in victims:
                    self._fail_lane(lane, f"hub {ev.target} power loss",
                                    min_lease_s=ev.duration)
        elif ev.kind == flt.LINK_DOWN:
            if self.fabric is not None:
                a, b = ev.target
                self.fabric.set_link_state(a, b, up=False)
                self.report.faults["link_down"] += 1
                if ev.duration > 0:
                    self._push_event(self.now + ev.duration,
                                     self._fault_link_restore, (a, b))

    def _fault_link_restore(self, pair: tuple):
        self.fabric.set_link_state(pair[0], pair[1], up=True)
        self.report.faults["link_up"] += 1
        # blocked handoffs re-probe on their own backoff timers; frames
        # parked in the hold buffer can flow again now
        self._drain_hold_buffer()

    def _find_lane(self, name) -> Optional[_Lane]:
        for lane in self._lane_by_cart.values():
            if lane.cart.name == name:
                return lane
        return None

    # .. failure + recovery ....................................................
    def _fail_lane(self, lane: _Lane, reason: str, min_lease_s: float = 0.0):
        """The device is gone (crash, hub power loss, or a promoted
        hang): quarantine it, recover every frame it owned, stop its
        power draw, and schedule the lease-expiry reinstatement."""
        name = lane.cart.name
        until = self.qledger.quarantine(name, self.now,
                                        min_lease_s=min_lease_s)
        self._down.add(id(lane))
        self.registry.set_failed(lane.cart, True)
        self.report.faults["quarantined"] += 1
        self.report.swap_log.append(
            (self.now, "fault", f"{name}: {reason}; quarantined until "
                                f"{until:.3f}"))
        lane.hang_next = False
        if lane.wd_handle is not None:
            self._events.cancel(lane.wd_handle)
            lane.wd_handle = None
        if lane.busy:
            inflight_batch: list = []
            if lane.inflight is not None:
                handle, inflight_batch = lane.inflight
                self._events.cancel(handle)  # False if already hung: fine
                lane.inflight = None
            lane.set_busy(False)
            if self._trace is not None:
                self._trace_service_end(lane, status="aborted")
            # settle the energy uplift and clear the health ledger without
            # teaching either that the aborted cycle was a completion
            self.governor.on_cycle_end(self.now, lane.cart)
            self.health.abort_request(name, self.now)
            self._recover_copies(lane, inflight_batch)
        if lane.queue:
            queued = list(lane.queue)
            lane.queue.clear()
            self._recover_copies(lane, queued)
        if lane.held is not None:
            # the serviced results died in the device's output buffer:
            # recompute (re-dispatch at the lane's own stage)
            held = lane.held
            lane.set_held(None)
            self._recover_copies(lane, held)
        self._sync_governor()                # a dead stick stops drawing
        self._push_event(until, self._reinstate_lane, lane)

    def _recover_copies(self, lane: _Lane, msgs: list):
        """Re-dispatch frames a dead lane owned, preserving exactly-once
        through the hedge ledger: if another live copy of a frame exists
        the dead copy is simply dropped (the loser-suppression accounting
        already guarantees single delivery); the last live copy is
        stripped of hedge state and re-dispatched with backoff."""
        pos = self._slot_index.get(lane.slot, lane.pos)
        for m in msgs:
            key = (lane.slot, m.seq)
            task = self._hedges.get(key)
            if task is not None:
                if task.winner is not None:
                    # race already decided elsewhere: this copy is a dead
                    # loser whose suppression now happens for free
                    task.copies -= 1
                    if task.copies <= 0:
                        self._hedges.pop(key, None)
                    continue
                if task.copies > 1:
                    # another live copy survives: drop this one
                    task.copies -= 1
                    if lane is task.backup or m.meta.get("_hedge_copy"):
                        task.backup = None
                    self.report.hedges["cancelled_queued"] += 1
                    continue
                # last live copy: promote to sole owner and re-dispatch
                if task.check_handle is not None:
                    self._events.cancel(task.check_handle)
                self._hedges.pop(key, None)
                m.meta.pop("_hedge_copy", None)
            self.report.faults["redispatched"] += 1
            self._retry_dispatch(pos, m)

    def _reinstate_lane(self, lane: _Lane):
        """Lease expiry: return a quarantined lane to service — on
        probation (its pick-loop estimate carries the probation penalty
        until the window passes cleanly)."""
        if id(lane) not in self._down:
            return                           # already reinstated/handled
        name = lane.cart.name
        if self._group_of_lane(lane) is None:
            # unplugged while benched; registry cleared its fault state
            self._down.discard(id(lane))
            return
        if self.qledger.quarantined(name, self.now):
            # a flap extended the lease while this event was in flight
            self._push_event(self.qledger.until(name),
                             self._reinstate_lane, lane)
            return
        self._down.discard(id(lane))
        self.registry.set_failed(lane.cart, False)
        self.qledger.reinstate(name, self.now)
        self.report.faults["reinstated"] += 1
        self.report.swap_log.append(
            (self.now, "reinstate", f"{name} (on probation)"))
        self._sync_governor()                # idle draw resumes
        self._drain_hold_buffer()
        for g in list(self._groups):
            if g.mode == "broadcast":
                self._try_start_broadcast(g)
        self._try_start_lane(lane)

    # -- hot-swap (paper §3.2/§4.2) -------------------------------------------
    def schedule_remove(self, t: float, slot: int):
        self._push_event(t, self._do_remove, slot)

    def schedule_insert(self, t: float, slot: int, cart: Cartridge,
                        mode: str = "shard"):
        self._push_event(t, self._do_insert, slot, cart, mode)

    def schedule_add_replica(self, t: float, slot: int, cart: Cartridge,
                             hub: Optional[int] = None):
        self._push_event(t, self._do_add_replica, slot, cart, hub)

    def schedule_remove_replica(self, t: float, slot: int,
                                cart: Optional[Cartridge] = None):
        self._push_event(t, self._do_remove_replica, slot, cart)

    def _pause(self, dur: float, reason: str):
        t1 = max(self.paused_until, self.now + dur)
        self.report.downtime.append((self.now, t1, reason))
        self.paused_until = t1
        self._push_event(t1, self._resume)

    def _drain_hold_buffer(self):
        if self.now < self.paused_until or self.halted_since is not None:
            return
        # snapshot: with chaos active _enqueue may re-buffer a frame whose
        # whole group is still down — draining in place would spin forever
        pending = list(self._hold_buffer)
        self._hold_buffer.clear()
        for idx, m in pending:
            self._enqueue(min(idx, len(self._groups)), m)

    def _resume(self):
        if self.now < self.paused_until:
            return
        self._drain_hold_buffer()
        for g in list(self._groups):
            if g.mode == "broadcast":
                self._try_start_broadcast(g)
            else:
                for l in list(g.lanes):
                    self._try_start_lane(l)

    def _do_remove(self, slot: int):
        rec = self.registry.slots.get(slot)
        if rec is None:
            return
        idx = self._slot_index[slot]
        chain = self.registry.chain()
        up = chain[idx - 1] if idx > 0 else None
        down = chain[idx + 1] if idx + 1 < len(chain) else None
        # re-buffer frames queued at the removed group (zero loss); they
        # re-enter at this position, i.e. at the bridge or next stage
        victim = self._groups[idx]
        for lane in victim.lanes:
            self._rescue_lane(lane, idx)
        for m in victim.bqueue:
            self._hold_buffer.append((idx, m))
        victim.bqueue.clear()
        if victim.bheld is not None:
            self._hold_buffer.append((idx, victim.bheld))
            victim.bheld = None
        self._in_swap = True
        try:
            self.registry.remove(slot, self.now)
            upspec = up.produces if up else None
            downspec = down.consumes if down else None
            compatible = (up is None or down is None
                          or downspec.accepts(upspec))
            self.report.swap_log.append(
                (self.now, "remove", f"slot {slot} ({rec.cartridge.name})"))
            if self._trace is not None:
                self._trace.instant(trc.SWAP, self.now, track="engine",
                                    op="remove", slot=slot,
                                    name=rec.cartridge.name,
                                    bridged=compatible)
            if compatible:
                # paper: 'bridge the gap if the pipeline can continue
                # without that function' — chain shortens (pass-through)
                self._rebuild()
                self._pause(REMOVE_PAUSE_S, f"remove slot {slot}")
            else:
                # paper: 'triggers an alert for operator intervention' —
                # halt; frames buffer (zero loss) until a compatible
                # cartridge is inserted
                self.halted_since = self.now
                self.report.alerts.append(
                    (self.now, f"capability '{rec.cartridge.name}' missing;"
                               f" pipeline halted for operator"))
        finally:
            self._in_swap = False

    def _do_insert(self, slot: int, cart: Cartridge, mode: str = "shard"):
        self._in_swap = True
        try:
            # clear any bridge occupying this slot
            if slot in self.registry.slots and isinstance(
                    self.registry.slots[slot].cartridge, PassThrough):
                self.registry.remove(slot, self.now)
            load_s = cart.device.load_s
            self.registry.insert(slot, cart, self.now, mode=mode)
            self._stub_load(cart)
            self._rebuild()
        finally:
            self._in_swap = False
        self.report.swap_log.append(
            (self.now, "insert", f"slot {slot} ({cart.name})"))
        if self._trace is not None:
            self._trace.instant(trc.SWAP, self.now, track="engine",
                                op="insert", slot=slot, name=cart.name,
                                load_s=load_s)
        if self.halted_since is not None:
            # operator supplied the missing capability: close the halt
            # window and resume
            t0 = self.halted_since
            self.halted_since = None
            self.report.downtime.append(
                (t0, self.now, f"halted awaiting capability (slot {slot})"))
        self._pause(HANDSHAKE_S + load_s, f"insert slot {slot}")

    def _do_add_replica(self, slot: int, cart: Cartridge,
                        hub: Optional[int] = None):
        """Plug one more device into an existing lane group (optionally on
        a specific fabric hub).  The pipeline keeps streaming; the new
        lane joins after handshake + model load."""
        if slot not in self.registry.slots:
            return
        self._in_swap = True
        try:
            self.registry.add_replica(slot, cart, self.now, hub=hub)
            self._stub_load(cart)
            self._rebuild()
        finally:
            self._in_swap = False
        for g in self._groups:
            for lane in g.lanes:
                if lane.cart is cart:
                    lane.set_ready_at(self.now + HANDSHAKE_S +
                                      cart.device.load_s)
        self.report.swap_log.append(
            (self.now, "add_replica", f"slot {slot} ({cart.name})"))
        if self._trace is not None:
            self._trace.instant(trc.SWAP, self.now, track="engine",
                                op="add_replica", slot=slot, name=cart.name)

    def _do_remove_replica(self, slot: int, cart: Optional[Cartridge]):
        """Unplug one replica.  With surviving lanes the group degrades
        throughput (no pause, no halt); the last replica falls back to the
        whole-slot removal semantics (bridge or operator alert)."""
        rec = self.registry.slots.get(slot)
        if rec is None:
            return
        victim_cart = cart if cart is not None else rec.replicas[-1]
        if len(rec.replicas) <= 1:
            self._do_remove(slot)
            return
        self._in_swap = True
        try:
            self.registry.remove_replica(slot, victim_cart, self.now)
            self._rebuild()
        finally:
            self._in_swap = False
        self.report.swap_log.append(
            (self.now, "remove_replica", f"slot {slot} "
                                         f"({victim_cart.name})"))
        if self._trace is not None:
            self._trace.instant(trc.SWAP, self.now, track="engine",
                                op="remove_replica", slot=slot,
                                name=victim_cart.name)
        # the rebuild's rescue pass parked the victim's backlog in the hold
        # buffer; with no pause it redistributes to surviving lanes now
        # (the victim's in-flight batch still completes before detach)
        self._drain_hold_buffer()

    def _stub_load(self, cart: Cartridge):
        if not cart._loaded:
            if self.execute_payloads:
                cart.load()
            else:
                cart._loaded = True
                cart._fn = lambda p, x: x


def validate_chain(chain: List[Cartridge]):
    """Type-check consume/produce contracts along the chain (registration-
    time validation, paper §3.2)."""
    for a, b in zip(chain, chain[1:]):
        if not b.consumes.accepts(a.produces):
            raise msg.TypeError_(
                f"{a.name} produces {a.produces.describe()} but "
                f"{b.name} consumes {b.consumes.describe()}")
