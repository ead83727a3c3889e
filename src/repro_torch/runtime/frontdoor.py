"""Fleet front door — multi-tenant admission for the serving stack.

Everything through PR 9 is a closed-loop single-operator engine: one
``StreamEngine.feed()`` call owns the whole box.  The paper's
applications (field biometrics, surveillance, disaster response) are
explicitly multi-consumer — several operators and bulk jobs sharing one
CHAMP box — so ingest needs an *admission* layer in front of dispatch:

``Tenant``
    One traffic source: a priority class (0 = highest; classes shed
    last-to-first), a WFQ ``weight`` (long-run service share under
    contention), an optional token-bucket ``rate_fps`` credit, an
    optional end-to-end ``slo_s`` target (drives the engine's hedge
    deadlines), and a bounded per-tenant queue.

``FrontDoor``
    The admission controller.  Arrivals ``offer()``; the door either
    admits immediately (capacity slot open + token available), parks the
    frame in the tenant's queue, or sheds it.  Queued frames drain by
    weighted-fair queuing — stride scheduling on virtual finish times,
    so long-run admission shares converge to the weight ratio under any
    arrival interleaving.  Under aggregate overload the *lowest* class
    with backlog is preempted first (graceful degradation: bulk work
    sheds, interactive work keeps its share — never queue collapse).

    Backpressure closes the loop from fleet health: the admission pacer
    runs off the engine's *live* capacity (parked hubs and dead lanes
    contribute nothing; throttled hubs contribute ``1/inflation``;
    quarantine probation discounts a lane's rate), and every tenant's
    token refill is scaled by ``credit = live/nominal`` — a parked hub
    shrinks the whole credit pool instead of letting queues balloon.

The one-flag discipline (the ``_chaos`` / ``trace=None`` lesson): a
door with a single tenant and no rate caps is **not engaged** —
``offer()`` is a pure synchronous pass-through, so ``feed()`` on a
default door is float-for-float bit-identical to the pre-door ingest
path.  All pacing/queueing/shedding machinery exists only behind
``engaged``.

Conservation invariant (property-tested): per tenant, at any instant,
``offered == admitted + shed + queued``.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

from repro_torch.runtime import trace as trc
from repro_torch.runtime.metrics import StreamingHistogram

# canonical priority-class names (any int >= 0 is legal; these are the
# conventional tiers used by serve.py and the bench)
CLASS_NAMES = {0: "interactive", 1: "standard", 2: "bulk"}


def class_name(priority: int) -> str:
    return CLASS_NAMES.get(priority, f"class{priority}")


@dataclass(frozen=True)
class Tenant:
    """One admission contract.  Frozen: identity and terms never mutate
    mid-run (re-negotiation = new tenant)."""
    name: str
    priority: int = 1             # class: 0 sheds last, larger sheds first
    weight: float = 1.0           # WFQ share under contention
    rate_fps: Optional[float] = None   # token refill rate; None = uncapped
    burst: float = 16.0           # token-bucket depth (frames)
    slo_s: Optional[float] = None      # end-to-end latency target
    queue_cap: int = 256          # per-tenant front-door queue bound

    def __post_init__(self):
        if self.priority < 0:
            raise ValueError("priority class must be >= 0")
        if self.weight <= 0.0:
            raise ValueError("weight must be positive")
        if self.rate_fps is not None and self.rate_fps <= 0.0:
            raise ValueError("rate_fps must be positive (or None)")
        if self.burst < 1.0:
            raise ValueError("burst must allow at least one frame")
        if self.queue_cap < 1:
            raise ValueError("queue_cap must be >= 1")


class _TenantState:
    """Mutable per-tenant runtime: bucket, queue, WFQ clock, counters."""

    __slots__ = ("tenant", "tokens", "tok_t", "queue", "vt",
                 "offered", "admitted", "shed_overflow", "shed_preempted",
                 "queued_peak", "completed", "slo_miss", "wait_s", "lat")

    def __init__(self, tenant: Tenant):
        self.tenant = tenant
        self.tokens = tenant.burst      # start full: bursts admit cold
        self.tok_t = 0.0
        self.queue: deque = deque()
        self.vt = 0.0                   # WFQ virtual finish time
        self.offered = 0
        self.admitted = 0
        self.shed_overflow = 0          # dropped at the door (queue full)
        self.shed_preempted = 0         # evicted from queue by class shed
        self.queued_peak = 0
        self.completed = 0
        self.slo_miss = 0
        self.wait_s = 0.0               # total front-door queue wait
        self.lat = StreamingHistogram()

    @property
    def shed(self) -> int:
        return self.shed_overflow + self.shed_preempted

    def capped(self) -> bool:
        return self.tenant.rate_fps is not None


class FrontDoor:
    """Multi-tenant admission controller in front of ``StreamEngine``.

    ``headroom``        fraction of live capacity the pacer admits at
                        (< 1 keeps dispatch queues shallow so class-0
                        latency stays near service time under overload).
    ``min_credit``      floor on the health credit ``live/nominal`` so a
                        brief brown-out cannot zero every token bucket.
    ``max_poll_s``      drain re-check bound while backlogged: caps how
                        stale the capacity estimate can get after a hub
                        parks or recovers.
    ``total_queue_cap`` aggregate bound across all tenant queues; beyond
                        it the lowest backlogged class is preempted.
    ``inflight_s``      target pipeline sojourn: admissions stall once
                        ``live_fps * inflight_s`` frames are in flight,
                        so completions — not the capacity estimate —
                        clock admission under saturation and any
                        transient over-admission drains immediately.
    """

    def __init__(self, *, headroom: float = 0.95, min_credit: float = 0.05,
                 max_poll_s: float = 0.25, total_queue_cap: int = 1024,
                 inflight_s: float = 0.25, min_window: int = 4):
        if not 0.0 < headroom <= 1.0:
            raise ValueError("headroom must be in (0, 1]")
        self.headroom = headroom
        self.min_credit = min_credit
        self.max_poll_s = max_poll_s
        self.total_queue_cap = total_queue_cap
        self.inflight_s = inflight_s
        self.min_window = min_window
        self._inflight = 0              # admitted minus completed/lost
        self._states: Dict[str, _TenantState] = {}
        self.default_tenant: Optional[str] = None
        self.has_slo = False            # engine gates hedge coupling on this
        self._gate = 0.0                # next admission-slot time
        self._v = 0.0                   # WFQ virtual clock
        self._queued_total = 0
        self._drain_pending = False
        self.last_credit = 1.0
        # host hooks (bind): virtual clock, event scheduler, admission
        # sink, live/nominal capacity probe, optional flight recorder
        self._clock: Callable[[], float] = lambda: 0.0
        self._schedule: Callable[[float, Callable], object] = \
            lambda t, fn: (_ for _ in ()).throw(
                RuntimeError("FrontDoor not bound to a scheduler"))
        self._admit_cb: Callable[[object], None] = lambda m: None
        self._capacity: Callable[[], tuple] = lambda: (float("inf"),
                                                       float("inf"))
        self._tracer = None
        # capacity snapshots are cached per virtual timestamp: every
        # offer in one event cohort shares the lane scan
        self._cap_t = -1.0
        self._cap = (float("inf"), float("inf"))

    # -- configuration --------------------------------------------------------
    def add_tenant(self, tenant, **kw) -> Tenant:
        """Register a tenant (a ``Tenant`` or a name plus field kwargs).
        The first tenant registered is the default ``feed()`` target."""
        if not isinstance(tenant, Tenant):
            tenant = Tenant(name=str(tenant), **kw)
        elif kw:
            raise ValueError("pass a Tenant or kwargs, not both")
        if tenant.name in self._states:
            raise ValueError(f"tenant {tenant.name!r} already registered")
        self._states[tenant.name] = _TenantState(tenant)
        if self.default_tenant is None:
            self.default_tenant = tenant.name
        if tenant.slo_s is not None:
            self.has_slo = True
        return tenant

    def tenant(self, name: str) -> Tenant:
        return self._states[name].tenant

    @property
    def tenant_names(self):
        return list(self._states)

    @property
    def engaged(self) -> bool:
        """Admission machinery on?  A single uncapped tenant is a pure
        pass-through (the bit-identity contract); more than one tenant,
        or any rate credit, engages pacing/queueing/shedding."""
        if len(self._states) > 1:
            return True
        return any(st.capped() for st in self._states.values())

    # -- host binding ---------------------------------------------------------
    def bind(self, *, clock, schedule, admit, capacity, tracer=None):
        """Attach to a host engine: ``clock()`` -> now, ``schedule(t, fn)``
        defers a drain, ``admit(m)`` hands a frame to dispatch,
        ``capacity()`` -> ``(live_fps, nominal_fps)`` of the bottleneck
        stage.  ``StreamEngine.attach_frontdoor`` wires all four."""
        self._clock = clock
        self._schedule = schedule
        self._admit_cb = admit
        self._capacity = capacity
        self._tracer = tracer
        if not self._states:
            self.add_tenant("default")

    # -- admission ------------------------------------------------------------
    def offer(self, name: str, m, t: float) -> str:
        """One frame arrives for ``name`` at virtual time ``t``.  Returns
        the verdict: ``"admit"``, ``"queue"``, or ``"shed"``."""
        st = self._states[name]
        st.offered += 1
        if not self.engaged:           # pass-through: bit-identical ingest
            st.admitted += 1
            self._admit_cb(m)
            return "admit"
        live, credit = self._capacity_now(t)
        self._refill(st, t, credit)
        if not st.queue and t >= self._gate and live > 1e-6 \
                and self._inflight < self._window(live) \
                and (not st.capped() or st.tokens >= 1.0):
            self._admit_one(st, m, t, live)
            return "admit"
        return self._park_or_shed(st, m, t)

    def _park_or_shed(self, st: _TenantState, m, t: float) -> str:
        if len(st.queue) >= st.tenant.queue_cap:
            self._shed(st, m, t, "overflow")
            return "shed"
        if self._queued_total >= self.total_queue_cap:
            victim = self._shed_victim(st)
            if victim is None:          # arriving class is the lowest
                self._shed(st, m, t, "overflow")
                return "shed"
            evicted = victim.queue.pop()    # newest bulk frame goes first
            self._queued_total -= 1
            victim.shed_preempted += 1
            self._trace_shed(victim, evicted, t, "preempted")
        st.queue.append(m)
        self._queued_total += 1
        if len(st.queue) > st.queued_peak:
            st.queued_peak = len(st.queue)
        self._schedule_drain(t)
        return "queue"

    def _shed_victim(self, incoming: _TenantState) -> Optional[_TenantState]:
        """Lowest-class backlogged tenant strictly below the arrival's
        class (ties never preempt: a class cannot shed itself)."""
        victim = None
        for st in self._states.values():
            if not st.queue or st.tenant.priority <= incoming.tenant.priority:
                continue
            if victim is None or \
                    (st.tenant.priority, st.tenant.name) > \
                    (victim.tenant.priority, victim.tenant.name):
                victim = st
        return victim

    def _shed(self, st: _TenantState, m, t: float, why: str):
        st.shed_overflow += 1
        self._trace_shed(st, m, t, why)

    # -- pacing ---------------------------------------------------------------
    def _window(self, live: float) -> float:
        """Admission window: frames allowed in flight at once."""
        if live == float("inf"):
            return float("inf")
        return max(self.min_window, int(live * self.inflight_s))

    def _capacity_now(self, t: float):
        """(live_fps, credit) — cached per virtual timestamp."""
        if t != self._cap_t:
            self._cap_t = t
            self._cap = self._capacity()
        live, nominal = self._cap
        if nominal <= 0.0 or nominal == float("inf"):
            credit = 1.0
        else:
            credit = min(1.0, max(self.min_credit, live / nominal))
        self.last_credit = credit
        return live, credit

    def _refill(self, st: _TenantState, t: float, credit: float):
        if st.capped():
            dt = t - st.tok_t
            if dt > 0.0:
                st.tokens = min(st.tenant.burst,
                                st.tokens + dt * st.tenant.rate_fps * credit)
        st.tok_t = t

    def _admit_one(self, st: _TenantState, m, t: float, live: float):
        """Consume an admission slot + token, advance the WFQ clock, and
        hand the frame to dispatch.  ``m.t_created`` is the *offer* time,
        so front-door queue wait counts against latency and SLO."""
        if st.capped():
            st.tokens -= 1.0
        self._inflight += 1
        self._v = max(self._v, st.vt)
        st.vt = self._v + 1.0 / st.tenant.weight
        self._gate = max(self._gate, t) + 1.0 / (live * self.headroom)
        st.admitted += 1
        wait = t - getattr(m, "t_created", t)
        if wait > 0.0:
            st.wait_s += wait
            if self._tracer is not None and \
                    self._tracer.sampled(getattr(m, "seq", -1)):
                self._tracer.instant(
                    trc.TENANT_ADMIT, t, track=f"tenant:{st.tenant.name}",
                    seq=getattr(m, "seq", -1), wait_s=wait,
                    tenant=st.tenant.name)
        self._admit_cb(m)

    def _schedule_drain(self, t: float):
        if self._drain_pending:
            return
        live, _ = self._capacity_now(t)
        nxt = self._gate if live > 1e-6 else t + self.max_poll_s
        nxt = min(max(nxt, t + 1e-6), t + self.max_poll_s)
        self._drain_pending = True
        self._schedule(nxt, self._drain)

    def _drain(self):
        """Admit queued frames by WFQ order while slots and tokens last;
        re-arm while any backlog remains."""
        self._drain_pending = False
        t = self._clock()
        live, credit = self._capacity_now(t)
        if live <= 1e-6:                # fleet brown-out: hold, re-check
            if self._queued_total:
                self._schedule_drain(t)
            return
        for st in self._states.values():
            self._refill(st, t, credit)
        win = self._window(live)
        while self._gate <= t and self._queued_total and self._inflight < win:
            st = self._next_wfq()
            if st is None:              # backlog exists but no tokens yet
                break
            m = st.queue.popleft()
            self._queued_total -= 1
            self._admit_one(st, m, t, live)
        if self._queued_total:
            self._schedule_drain(t)

    def _next_wfq(self) -> Optional[_TenantState]:
        """Min virtual-finish-time among eligible backlogged tenants
        (deterministic tie-break: class, then name)."""
        best = None
        for st in self._states.values():
            if not st.queue or (st.capped() and st.tokens < 1.0):
                continue
            key = (st.vt, st.tenant.priority, st.tenant.name)
            if best is None or key < best[0]:
                best = (key, st)
        return None if best is None else best[1]

    # -- completion + accounting ----------------------------------------------
    def on_complete(self, name: str, latency_s: float, t: float):
        """Engine callback at frame completion: per-tenant latency and
        SLO accounting, and the ack that frees an admission slot."""
        st = self._states[name]
        st.completed += 1
        st.lat.record(latency_s)
        slo = st.tenant.slo_s
        if slo is not None and latency_s > slo:
            st.slo_miss += 1
        self._inflight = max(0, self._inflight - 1)
        if self._queued_total:          # a slot just freed: ack-clock
            self._schedule_drain(t)

    def on_drop(self, name: str, t: float):
        """Engine callback when an admitted frame is lost in-pipeline:
        the slot must still be returned or the window leaks shut."""
        self._inflight = max(0, self._inflight - 1)
        if self._queued_total:
            self._schedule_drain(t)

    def _trace_shed(self, st: _TenantState, m, t: float, why: str):
        if self._tracer is not None and \
                self._tracer.sampled(getattr(m, "seq", -1)):
            self._tracer.instant(
                trc.TENANT_SHED, t, track=f"tenant:{st.tenant.name}",
                seq=getattr(m, "seq", -1), reason=why,
                tenant=st.tenant.name, priority=st.tenant.priority)

    def check_conservation(self) -> dict:
        """offered == admitted + shed + queued, per tenant.  Returns the
        per-tenant ledger; raises AssertionError on any leak."""
        out = {}
        for name, st in self._states.items():
            ledger = {"offered": st.offered, "admitted": st.admitted,
                      "shed": st.shed, "queued": len(st.queue)}
            assert st.offered == st.admitted + st.shed + len(st.queue), \
                f"front-door conservation leak for {name!r}: {ledger}"
            out[name] = ledger
        return out

    def summary(self) -> dict:
        """JSON-safe snapshot for ``EngineReport.frontdoor`` and the
        ``tenant.*`` metrics namespace."""
        self.check_conservation()
        tenants = {}
        for name, st in self._states.items():
            tn = st.tenant
            goodput = st.completed / st.offered if st.offered else 0.0
            tenants[name] = {
                "class": class_name(tn.priority),
                "priority": tn.priority,
                "weight": tn.weight,
                "rate_fps": tn.rate_fps,
                "slo_s": tn.slo_s,
                "offered": st.offered,
                "admitted": st.admitted,
                "shed": st.shed,
                "shed_overflow": st.shed_overflow,
                "shed_preempted": st.shed_preempted,
                "queued": len(st.queue),
                "queued_peak": st.queued_peak,
                "completed": st.completed,
                "goodput": goodput,
                "avg_wait_s": (st.wait_s / st.admitted
                               if st.admitted else 0.0),
                "slo_miss": st.slo_miss,
                "slo_hit_rate": (1.0 - st.slo_miss / st.completed
                                 if st.completed else 1.0),
                "latency": st.lat.summary(),
            }
        return {
            "engaged": self.engaged,
            "headroom": self.headroom,
            "credit": self.last_credit,
            "offered": sum(s.offered for s in self._states.values()),
            "admitted": sum(s.admitted for s in self._states.values()),
            "shed": sum(s.shed for s in self._states.values()),
            "queued": self._queued_total,
            "tenants": tenants,
        }
