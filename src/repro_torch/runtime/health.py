"""Health monitoring + straggler mitigation for serving pipelines.

VDiSK's health daemon, generalized to datacenter scale: every stage (or
data-parallel worker) posts heartbeats; a worker whose in-flight request
exceeds ``straggler_factor x`` the stage's trailing latency percentile gets
its request *backup-dispatched* to a healthy peer (tied-request / hedged
execution — the standard tail-latency mitigation), and a worker that
misses ``dead_after_s`` of heartbeats is declared failed, which triggers
the same path as a cartridge removal (bypass / re-mesh).

The ``StreamEngine``'s hedged shard dispatch is the event-driven face of
the same tied-request machinery: the engine feeds every lane service
start/finish through a ``HealthMonitor`` and reports each hedge through
``record_backup``, so one straggler ledger (``events``,
``backup_dispatches``) covers both the polled datacenter path
(``check``) and the event-driven edge path.
"""
from __future__ import annotations

import math
from collections import defaultdict, deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from .faults import QuarantinePolicy


def quantile(xs, q: float) -> float:
    """Nearest-rank quantile of a sequence; +inf when empty (so straggler
    thresholds derived from it never fire without evidence)."""
    if not xs:
        return float("inf")
    s = sorted(xs)
    return s[min(int(math.ceil(q * len(s))) - 1, len(s) - 1)]


@dataclass(slots=True)
class WorkerState:
    last_heartbeat: float = 0.0
    inflight_since: Optional[float] = None
    inflight_id: Optional[int] = None
    done: int = 0
    backup_dispatches: int = 0
    alive: bool = True


class HealthMonitor:
    def __init__(self, *, dead_after_s: float = 3.0,
                 straggler_factor: float = 3.0, window: int = 64):
        self.dead_after_s = dead_after_s
        self.straggler_factor = straggler_factor
        self.workers: Dict[str, WorkerState] = defaultdict(WorkerState)
        self.latencies: deque = deque(maxlen=window)
        self.events: List[tuple] = []

    def heartbeat(self, worker: str, t: float):
        w = self.workers[worker]
        w.last_heartbeat = t
        if not w.alive:
            w.alive = True
            self.events.append((t, "rejoin", worker))

    def start_request(self, worker: str, req_id: int, t: float):
        w = self.workers[worker]
        w.inflight_since, w.inflight_id = t, req_id
        w.last_heartbeat = t

    def finish_request(self, worker: str, t: float):
        w = self.workers[worker]
        if w.inflight_since is not None:
            self.latencies.append(t - w.inflight_since)
        w.inflight_since = w.inflight_id = None
        w.done += 1
        w.last_heartbeat = t

    def abort_request(self, worker: str, t: float):
        """The in-flight request died with its worker (crash, or a hang
        promoted by the watchdog): clear it *without* recording a latency
        sample — the request never completed, and a fault must not teach
        the straggler threshold that slow is normal."""
        w = self.workers[worker]
        w.inflight_since = w.inflight_id = None
        self.events.append((t, "aborted", worker))

    def record_backup(self, worker: str, t: float,
                      req_id: Optional[int] = None):
        """Note that ``worker``'s in-flight request was backup-dispatched
        (tied-request hedge) to a peer.  Shared ledger entry for both the
        polled ``check`` path and the engine's event-driven hedge path."""
        self.workers[worker].backup_dispatches += 1
        self.events.append((t, "straggler", worker))

    def _p90(self) -> float:
        return quantile(self.latencies, 0.9)

    def check(self, t: float):
        """Returns (dead_workers, straggler (worker, req_id) pairs)."""
        dead, stragglers = [], []
        thresh = self.straggler_factor * self._p90()
        for name, w in self.workers.items():
            if not w.alive:
                continue
            if t - w.last_heartbeat > self.dead_after_s:
                w.alive = False
                dead.append(name)
                self.events.append((t, "dead", name))
                continue
            if w.inflight_since is not None and \
                    t - w.inflight_since > thresh:
                stragglers.append((name, w.inflight_id))
                self.record_backup(name, t, w.inflight_id)
        return dead, stragglers


@dataclass(slots=True)
class _Lease:
    until: float = 0.0            # quarantined while now < until
    lease_s: float = 0.0          # the lease this bench was granted
    probation_until: float = 0.0  # penalized (and flap-sensitive) window
    faults: int = 0
    flaps: int = 0
    reinstatements: int = 0


class QuarantineLedger:
    """Lease-based lane quarantine with probationary reinstatement.

    The engine benches a faulted lane here; while quarantined the lane is
    excluded from every pick set (shard, hedge backup, broadcast, route
    fallback).  When the lease expires the lane re-enters *on probation*:
    its completion estimate is inflated by ``policy.probation_penalty``
    so it earns traffic back gradually instead of re-entering the EWMA
    loop at full weight.

    Hysteresis: a fault during probation — the signature of a flapper —
    doubles the lease (``policy.flap_factor``, capped at
    ``policy.lease_cap_s``).  A lane that fails at exactly the probation
    period therefore sits out 1×, 2×, 4×, … leases rather than
    oscillating in and out of the pick set every cycle; the boundary
    itself (``t == probation_until``) counts as a flap so the oscillation
    period has no resonant fixed point.
    """

    def __init__(self, policy: Optional[QuarantinePolicy] = None):
        self.policy = policy or QuarantinePolicy()
        self._st: Dict[str, _Lease] = {}
        # optional FlightRecorder: quarantine/reinstate emit instants —
        # the ledger alone sees flap escalation, so it owns the detail
        self.tracer = None

    def quarantine(self, name: str, t: float,
                   min_lease_s: float = 0.0) -> float:
        """Bench ``name`` at time ``t``; returns the lease expiry."""
        p = self.policy
        st = self._st.setdefault(name, _Lease())
        flapped = st.faults > 0 and t <= st.probation_until
        if flapped:
            # Faulted while quarantined or on probation: flap — escalate.
            st.flaps += 1
            st.lease_s = min(max(st.lease_s, p.lease_s) * p.flap_factor,
                             p.lease_cap_s)
        else:
            st.lease_s = p.lease_s
        st.lease_s = max(st.lease_s, min_lease_s)
        st.faults += 1
        st.until = t + st.lease_s
        st.probation_until = st.until + p.probation_s
        if self.tracer is not None:
            self.tracer.instant("quarantine", t, track=name,
                                lease_s=st.lease_s, until=st.until,
                                flapped=flapped, faults=st.faults)
        return st.until

    def quarantined(self, name: str, t: float) -> bool:
        st = self._st.get(name)
        return st is not None and t < st.until

    def until(self, name: str) -> float:
        st = self._st.get(name)
        return st.until if st is not None else 0.0

    def penalty(self, name: str, t: float) -> float:
        """Completion-estimate multiplier for the pick loop: the
        probation penalty while on probation, 1.0 once clean."""
        st = self._st.get(name)
        if st is None or t >= st.probation_until or t < st.until:
            return 1.0
        return self.policy.probation_penalty

    def reinstate(self, name: str, t: float):
        st = self._st.get(name)
        if st is not None:
            st.reinstatements += 1
            if self.tracer is not None:
                self.tracer.instant("reinstate", t, track=name,
                                    probation_until=st.probation_until,
                                    penalty=self.policy.probation_penalty)

    def summary(self) -> dict:
        return {name: {"faults": st.faults, "flaps": st.flaps,
                       "reinstatements": st.reinstatements,
                       "lease_s": st.lease_s}
                for name, st in sorted(self._st.items())}
