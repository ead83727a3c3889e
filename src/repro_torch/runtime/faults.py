"""Deterministic fault injection for the chaos fabric.

CHAMP's pitch is field operation — sticks die, hubs brown out, USB links
flake mid-mission — so the engine needs *unplanned* membership change as
a first-class event, not just hot-swap (planned) and hedging (slowness).
This module is the pure-data half of that story: a ``FaultPlan`` schedules
faults at virtual timestamps, a ``RetryPolicy`` shapes the backoff of
every recovery path, and a ``QuarantinePolicy`` tunes the lease/probation
state machine that keeps flapping lanes out of the EWMA pick loop.  The
mechanism that *acts* on these lives in ``engine.py`` / ``health.py`` /
``fabric.py``.

Everything here is replay-stable: all randomness comes from crc32 hashes
of (seed, kind, index) tuples, never from ``random`` or wall-clock, so
the same plan against the same scenario produces the same event trace on
every run and every host — the property the chaos bench's bit-identity
checks and the zero-loss CI gate both lean on.

Fault kinds
-----------
``LANE_CRASH``     the device vanishes mid-cycle; in-flight and queued
                   frames are re-dispatched, the lane is quarantined.
``LANE_HANG``      the service cycle never completes; the watchdog
                   (hedge-deadline histogram × margin) promotes the hang
                   into a failure.
``HUB_POWER_LOSS`` every lane on the hub crashes at once; the governor's
                   population sync stops their energy draw.
``LINK_DOWN``      an inter-hub link dies for ``duration`` seconds; the
                   router prices it at +inf and dispatch falls back to
                   alternate hubs (or holds frames until restore).
Transfer corruption is rate-based rather than scheduled: each bus
handoff draws against ``corrupt_p`` keyed on (seed, seq, attempt), and a
frame checksum at the receiver turns a hit into a detect + re-send.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass, field
from typing import Iterable, List, Optional, Sequence, Tuple, Union

LANE_CRASH = "lane_crash"
LANE_HANG = "lane_hang"
HUB_POWER_LOSS = "hub_power_loss"
LINK_DOWN = "link_down"

FAULT_KINDS = (LANE_CRASH, LANE_HANG, HUB_POWER_LOSS, LINK_DOWN)


def _u01(*parts) -> float:
    """Deterministic uniform in [0, 1) from a crc32 hash of the parts.

    Replay- and process-stable (no PYTHONHASHSEED dependence), matching
    the engine's service-jitter discipline.
    """
    key = ":".join(str(p) for p in parts).encode()
    return (zlib.crc32(key) & 0xFFFFFFFF) / 4294967296.0


def frame_checksum(m) -> int:
    """Checksum stamped on each frame at bus handoff and verified at the
    receiver.  Covers the identity fields a corrupted transfer would
    scramble; the stamp itself lives in ``m.meta['_csum']`` and is *not*
    part of the hashed payload, so verification is self-consistent."""
    return zlib.crc32(f"{m.seq}:{m.kind}:{m.meta.get('bytes', 0)}".encode())


@dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault.  ``target`` is a lane cartridge name for
    lane faults, a hub id for ``HUB_POWER_LOSS``, and an ``(a, b)`` hub
    pair for ``LINK_DOWN``.  ``duration`` is the outage window for link
    faults and the minimum quarantine lease for crash/power faults
    (0 → policy default)."""

    t: float
    kind: str
    target: Union[str, int, Tuple[int, int]]
    duration: float = 0.0

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; expected one of {FAULT_KINDS}")
        if self.t < 0 or self.duration < 0:
            raise ValueError("fault time/duration must be >= 0")

    def describe(self) -> dict:
        """Trace-arg form: plain scalars only (the ``(a, b)`` link
        target stringifies so exports stay JSON-stable)."""
        return {"fault": self.kind, "target": str(self.target),
                "duration_s": self.duration}


@dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff with deterministic jitter and a retry budget.

    Every recovery path (crashed-lane re-dispatch, corrupt-frame re-send,
    blocked-route re-probe) waits ``backoff(attempt)`` before trying
    again.  Jitter decorrelates retries that failed together without
    breaking replay: the draw is keyed on the caller-supplied key (frame
    seq), not on a PRNG stream.  The budget never *drops* a frame — zero
    loss is the contract — it marks the frame's alert threshold: once a
    frame burns more than ``budget`` retries the engine raises an alert
    so operators see pathological cells instead of silent crawling.
    """

    base_s: float = 0.005
    factor: float = 2.0
    max_s: float = 0.25
    jitter: float = 0.25
    budget: int = 6

    def backoff(self, attempt: int, key: str = "") -> float:
        d = min(self.base_s * self.factor ** max(attempt, 0), self.max_s)
        if self.jitter > 0:
            d *= 1.0 + self.jitter * (2.0 * _u01("retry", key, attempt) - 1.0)
        return d


@dataclass(frozen=True)
class QuarantinePolicy:
    """Lease-based quarantine with probationary reinstatement.

    A failed lane is benched for ``lease_s``; after the lease it re-enters
    the pick set *on probation* for ``probation_s`` with its completion
    estimate inflated by ``probation_penalty`` (so a returning lane must
    earn traffic back rather than re-entering the EWMA loop at full
    weight).  A fault during probation is a *flap*: the next lease is the
    previous one × ``flap_factor`` (capped at ``lease_cap_s``) — the
    hysteresis that stops a lane flapping at exactly the probation period
    from oscillating in and out of the pick set every cycle.
    """

    lease_s: float = 0.5
    lease_cap_s: float = 30.0
    flap_factor: float = 2.0
    probation_s: float = 0.5
    probation_penalty: float = 4.0


class FaultPlan:
    """A seeded, deterministic schedule of faults plus a transfer
    corruption rate.  Immutable once built; safe to share across runs
    (replaying the same plan gives the same fault trace)."""

    def __init__(self, events: Iterable[FaultEvent] = (),
                 corrupt_p: float = 0.0, seed: int = 0):
        if not 0.0 <= corrupt_p < 1.0:
            raise ValueError("corrupt_p must be in [0, 1)")
        self.events: Tuple[FaultEvent, ...] = tuple(
            sorted(events, key=lambda e: (e.t, e.kind, str(e.target))))
        self.corrupt_p = float(corrupt_p)
        self.seed = int(seed)

    @property
    def empty(self) -> bool:
        return not self.events and self.corrupt_p <= 0.0

    def corrupt_draw(self, seq: int, attempt: int) -> bool:
        """Does transmission ``attempt`` of frame ``seq`` corrupt?  Keyed
        per-attempt so a re-send of a corrupted frame redraws (and a
        retried frame isn't doomed to corrupt forever)."""
        if self.corrupt_p <= 0.0:
            return False
        return _u01(self.seed, "corrupt", seq, attempt) < self.corrupt_p

    def describe(self) -> dict:
        kinds: dict = {}
        for ev in self.events:
            kinds[ev.kind] = kinds.get(ev.kind, 0) + 1
        return {"seed": self.seed, "n_events": len(self.events),
                "by_kind": kinds, "corrupt_p": self.corrupt_p}

    @classmethod
    def storm(cls, seed: int, horizon_s: float, *,
              lanes: Sequence[str] = (),
              hubs: Sequence[int] = (),
              links: Sequence[Tuple[int, int]] = (),
              crash_rate: float = 0.0,
              hang_rate: float = 0.0,
              hub_loss_rate: float = 0.0,
              link_down_rate: float = 0.0,
              link_down_s: float = 0.15,
              corrupt_p: float = 0.0,
              t0: float = 0.05) -> "FaultPlan":
        """Generate a seeded fault storm: for each kind, ``rate`` is
        events per simulated second across the whole target set; event
        times and victims are hashed from (seed, kind, index), so the
        same arguments always yield the same storm.

        ``t0`` offsets the window so faults never land before the first
        frame is in flight (a crash at t=0 against an empty engine tests
        nothing).
        """
        span = max(horizon_s - t0, 0.0)
        events: List[FaultEvent] = []

        def _emit(kind: str, rate: float, targets: Sequence, duration_of):
            if rate <= 0 or span <= 0 or not targets:
                return
            n = int(round(rate * span))
            for i in range(n):
                t = t0 + span * _u01(seed, kind, "t", i)
                tgt = targets[int(_u01(seed, kind, "who", i) * len(targets))
                              % len(targets)]
                events.append(FaultEvent(t, kind, tgt, duration_of(i)))

        _emit(LANE_CRASH, crash_rate, list(lanes), lambda i: 0.0)
        _emit(LANE_HANG, hang_rate, list(lanes), lambda i: 0.0)
        _emit(HUB_POWER_LOSS, hub_loss_rate, list(hubs), lambda i: 0.0)
        _emit(LINK_DOWN, link_down_rate, list(links),
              lambda i: link_down_s * (0.5 + _u01(seed, LINK_DOWN, "dur", i)))
        return cls(events, corrupt_p=corrupt_p, seed=seed)
