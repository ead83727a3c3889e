"""Flight recorder: causal per-frame tracing + unified metrics registry.

The engine's counters (``EngineReport``) explain *what* happened over a
run; they cannot explain *why one frame was slow* — which lane won the
dispatch argmin and by how much, whether a hedge fork fired, how many
checksum resends a storm cost it, which cross-hub legs it paid for.
``FlightRecorder`` answers that with typed **spans** (begin/end pairs:
frame lifetime, service cycles, bus/fabric transfers) and **instants**
(dispatch decisions, hedge fork/win/loss, retries, quarantine, power
state transitions, fault injections) recorded into a preallocated
structure-of-arrays ring buffer — the PR 8 ``SoABank`` idiom, so a 10k
lane chaos storm traces in fixed memory (old entries are evicted, never
reallocated).

Design constraints, in order:

1. **Bit-identity when off.**  Following the PR 7 ``_chaos`` learning,
   every instrumentation site in the engine is gated on a single
   ``self._trace is not None`` check; with ``trace=`` unset the engine
   pushes exactly the same events in exactly the same order as before
   this module existed.  Tracing *on* must also never perturb virtual
   time: the recorder only observes, so traced and untraced runs produce
   float-for-float identical reports (pinned in the test suite and by
   ``benchmarks/obs_bench.py``).
2. **Low overhead when on.**  Sampling is decided once per frame at
   ingest (a crc32 hash of the frame id — replays of the same seed trace
   the *same* frames); per-site cost for unsampled frames is one set
   lookup.  Span writes are a handful of array stores.
3. **Deterministic.**  No wall clock, no ``random``: timestamps are the
   engine's virtual clock, sampling is hash-based, and the ring's entry
   ids are a monotonic counter — two runs of the same scenario produce
   byte-identical exports.

Exporters: ``frame_trace(frame_id)`` returns one frame's causal timeline
as plain dicts (tests, debugging); ``to_perfetto(path)`` writes Chrome
trace-event JSON that loads directly in Perfetto / ``chrome://tracing``
(tracks = lanes/hubs, slices = spans, arrows come free from the frame id
in each slice's args).

``MetricsRegistry`` is the other half of the observability story: one
namespaced, stable-name snapshot (``engine.frames.out``,
``hedge.issued``, ``faults.retries``, ``power.hub0.state``,
``gallery.match.rows_scored``, ...) unifying the stats surfaces that
previously lived in six different dicts.  ``EngineReport.metrics()``
builds it; ``ingest()`` merges any component's dict under a prefix.
"""
from __future__ import annotations

import json
import zlib
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from repro_torch.runtime.lanestate import SoABank

# span/instant kinds the engine emits; any string works — these are the
# stable names tests and docs refer to
FRAME = "frame"                 # span: ingest -> completion
SERVICE = "service"             # span: one lane service cycle
TRANSFER = "transfer"           # span: one bus/fabric hop (emitted closed)
DISPATCH = "dispatch"           # instant: lane chosen + argmin inputs
INGEST = "ingest"               # instant: frame entered the engine
COMPLETE = "complete"           # instant: frame delivered to the host
HEDGE_FORK = "hedge.fork"       # instant: backup copy issued
HEDGE_WIN = "hedge.win"         # instant: race decided
HEDGE_LOSS = "hedge.loss"       # instant: serviced loser suppressed
RETRY = "retry"                 # instant: one retry booked
CORRUPT = "corrupt.detected"    # instant: checksum mismatch at receiver
RESEND = "resend"               # instant: corrupted batch re-sent
QUARANTINE = "quarantine"       # instant: lane benched
REINSTATE = "reinstate"         # instant: lane back on probation
WATCHDOG = "watchdog.promoted"  # instant: hang promoted to failure
FAULT = "fault.injected"        # instant: a FaultPlan event landed
SWAP = "swap"                   # instant: hot-swap transaction
POWER = "power.state"           # instant: hub throttle/park transition
TENANT_ADMIT = "tenant.admit"   # instant: queued frame passed the door
TENANT_SHED = "tenant.shed"     # instant: front door shed a frame


def _sample_hash(seed: int, frame_id: int) -> int:
    """Replay-stable sampling draw, matching the faults.py crc32
    discipline (no PYTHONHASHSEED dependence)."""
    return zlib.crc32(f"{seed}:trace:{frame_id}".encode()) & 0xFFFFFFFF


class _TraceRing(SoABank):
    """Fixed-capacity SoA slab for trace entries.  Unlike the lane bank
    it never grows and never recycles through the free list: entry id
    modulo capacity IS the row, so eviction is a plain overwrite and the
    memory budget is set once at construction."""

    FIELDS_F64 = {"t0": 0.0, "t1": -1.0}
    # eid -1 marks a never-written row; kind/track index the intern
    # table; frame -1 marks engine-scoped (non-frame) entries
    FIELDS_I64 = {"eid": -1, "kind": -1, "frame": -1, "track": -1}


class FlightRecorder:
    """Typed span/instant ring buffer with deterministic frame sampling.

    ``capacity``   ring size (entries); oldest entries evict first.
    ``sample``     trace one frame in ``sample`` (1 = every frame),
                   chosen by a crc32 hash of ``(seed, frame_id)`` so the
                   same seed replays the identical traced-frame set.
    ``seed``       sampling key; engines seed it from their fault plan.

    The engine decides admission once per frame (``admit``); all other
    sites gate on ``watches(frame_id)`` — an O(1) set lookup.  Entries
    whose ``frame`` is -1 (power transitions, faults, swaps) bypass
    sampling: they are rare and fleet-scoped.
    """

    def __init__(self, capacity: int = 65536, sample: int = 1,
                 seed: int = 0):
        if capacity < 2:
            raise ValueError("ring capacity must be >= 2")
        if sample < 1:
            raise ValueError("sample must be >= 1 (1 = trace every frame)")
        self.capacity = capacity
        self.sample = int(sample)
        self.seed = int(seed)
        self._ring = _TraceRing(capacity)
        self._args: List[Optional[dict]] = [None] * capacity
        # string interning: kinds and track names repeat endlessly
        self._codes: Dict[str, int] = {}
        self._names: List[str] = []
        self._next = 0                      # monotonic entry id
        self._sampled: set = set()          # admitted frame ids
        self._open_frames: Dict[int, int] = {}   # frame id -> frame-span sid
        # virtual clock hook: components without engine access (gallery,
        # quarantine ledger) emit instants at clock(); the engine wires
        # this to its own ``now``
        self.clock: Callable[[], float] = lambda: 0.0
        # counters (the ``trace.*`` metrics namespace)
        self.spans_opened = 0
        self.spans_closed = 0
        self.instants = 0
        self.evicted = 0
        self.end_misses = 0                 # end() after the row evicted
        self.frames_admitted = 0
        self.frames_skipped = 0

    # -- sampling -------------------------------------------------------------
    def admit(self, frame_id: int) -> bool:
        """Decide once, at ingest, whether this frame is traced."""
        if self.sample > 1 and \
                _sample_hash(self.seed, frame_id) % self.sample != 0:
            self.frames_skipped += 1
            return False
        self._sampled.add(frame_id)
        self.frames_admitted += 1
        return True

    def watches(self, frame_id: int) -> bool:
        return frame_id in self._sampled

    def sampled(self, frame_id: int) -> bool:
        """Pure sampling probe (no admission bookkeeping): would this
        frame be traced?  Pre-admission sites — the front door sheds
        frames the engine never ingests — gate on this so shed instants
        follow the same deterministic 1/N policy as everything else."""
        return self.sample <= 1 or \
            _sample_hash(self.seed, frame_id) % self.sample == 0

    # -- recording ------------------------------------------------------------
    def _code(self, name: str) -> int:
        c = self._codes.get(name)
        if c is None:
            c = self._codes[name] = len(self._names)
            self._names.append(name)
        return c

    def _write(self, kind: str, t0: float, t1: float, frame: int,
               track: str, args: Optional[dict]) -> int:
        eid = self._next
        self._next = eid + 1
        i = eid % self.capacity
        ring = self._ring
        old = ring.eid[i]
        if old >= 0:
            self.evicted += 1
            # an open frame span falling off the ring can never be
            # closed; forget the stale sid so end() misses cleanly
            if ring.t1[i] < 0.0 and ring.kind[i] == self._codes.get(FRAME):
                self._open_frames.pop(int(ring.frame[i]), None)
        ring.eid[i] = eid
        ring.kind[i] = self._code(kind)
        ring.frame[i] = frame
        ring.track[i] = self._code(track)
        ring.t0[i] = t0
        ring.t1[i] = t1
        self._args[i] = args
        return eid

    def begin(self, kind: str, t: float, frame: int = -1,
              track: str = "engine", **args) -> int:
        """Open a span; returns its id for ``end``."""
        self.spans_opened += 1
        return self._write(kind, t, -1.0, frame, track, args or None)

    def end(self, sid: int, t: float, **args):
        """Close a span.  A span already evicted from the ring is a
        counted miss, never an error — eviction is the memory contract."""
        i = sid % self.capacity
        ring = self._ring
        if ring.eid[i] != sid or ring.t1[i] >= 0.0:
            self.end_misses += 1
            return
        ring.t1[i] = t
        if args:
            prev = self._args[i]
            self._args[i] = dict(prev, **args) if prev else args
        self.spans_closed += 1

    def span(self, kind: str, t0: float, t1: float, frame: int = -1,
             track: str = "engine", **args) -> int:
        """Emit an already-closed span (transfers: the arrival time is
        known at schedule time, so no open/close pairing is needed)."""
        self.spans_opened += 1
        self.spans_closed += 1
        return self._write(kind, t0, t1, frame, track, args or None)

    def instant(self, kind: str, t: float, frame: int = -1,
                track: str = "engine", **args) -> int:
        self.instants += 1
        return self._write(kind, t, t, frame, track, args or None)

    # frame-lifetime spans: the engine opens one per admitted frame at
    # ingest and closes it at completion; the recorder keeps the open
    # sid so re-dispatch/retry paths need no bookkeeping of their own
    def frame_begin(self, frame_id: int, t: float):
        self._open_frames[frame_id] = self.begin(FRAME, t, frame_id,
                                                 track=FRAME)

    def frame_end(self, frame_id: int, t: float, **args):
        sid = self._open_frames.pop(frame_id, None)
        if sid is not None:
            self.end(sid, t, **args)

    @property
    def open_frames(self) -> int:
        return len(self._open_frames)

    # -- export ---------------------------------------------------------------
    def _entry(self, i: int) -> dict:
        ring = self._ring
        d = {
            "id": int(ring.eid[i]),
            "kind": self._names[int(ring.kind[i])],
            "frame": int(ring.frame[i]),
            "track": self._names[int(ring.track[i])],
            "t0": float(ring.t0[i]),
        }
        t1 = float(ring.t1[i])
        if t1 != d["t0"]:
            d["t1"] = t1 if t1 >= 0.0 else None   # None = never closed
        args = self._args[i]
        if args:
            d["args"] = dict(args)
        return d

    def _live_rows(self) -> np.ndarray:
        """Row indices of written entries, oldest first (eid order)."""
        ring = self._ring
        rows = np.nonzero(ring.eid >= 0)[0]
        return rows[np.argsort(ring.eid[rows], kind="stable")]

    def frame_trace(self, frame_id: int) -> List[dict]:
        """One frame's causal timeline, in event order: ingest ->
        dispatch decision -> transfers -> service -> hedge activity ->
        retries -> completion.  Plain dicts for tests and debugging."""
        ring = self._ring
        rows = np.nonzero((ring.frame == frame_id) & (ring.eid >= 0))[0]
        rows = rows[np.argsort(ring.eid[rows], kind="stable")]
        return [self._entry(int(i)) for i in rows]

    def entries(self) -> List[dict]:
        """Every live ring entry, oldest first."""
        return [self._entry(int(i)) for i in self._live_rows()]

    def to_perfetto(self, path: str, time_unit_s: float = 1.0) -> int:
        """Write Chrome trace-event JSON (loads in Perfetto and
        chrome://tracing).  Virtual seconds map to trace microseconds
        scaled by ``time_unit_s``; tracks (lanes, hubs, the frame
        timeline) become threads of one process.  Returns the number of
        events written."""
        scale = 1e6 * time_unit_s
        tids: Dict[str, int] = {}
        events: List[dict] = []
        for name in sorted({self._names[int(self._ring.track[i])]
                            for i in self._live_rows()}):
            tids[name] = len(tids)
            events.append({"ph": "M", "name": "thread_name", "pid": 0,
                           "tid": tids[name], "args": {"name": name}})
        for i in self._live_rows():
            e = self._entry(int(i))
            args = dict(e.get("args") or {})
            if e["frame"] >= 0:
                args["frame"] = e["frame"]
            base = {"name": e["kind"], "pid": 0, "tid": tids[e["track"]],
                    "ts": e["t0"] * scale, "args": args}
            t1 = e.get("t1", e["t0"])
            if t1 is not None and t1 != e["t0"]:
                events.append(dict(base, ph="X",
                                   dur=(t1 - e["t0"]) * scale))
            elif t1 is None:                      # never closed: open slice
                events.append(dict(base, ph="X", dur=0.0))
            else:
                events.append(dict(base, ph="i", s="t"))
        with open(path, "w") as f:
            json.dump({"traceEvents": events,
                       "displayTimeUnit": "ms"}, f)
        return len(events)

    def snapshot(self) -> dict:
        """The ``trace.*`` metrics namespace."""
        return {
            "capacity": self.capacity,
            "sample": self.sample,
            "entries": int((self._ring.eid >= 0).sum()),
            "spans_opened": self.spans_opened,
            "spans_closed": self.spans_closed,
            "instants": self.instants,
            "evicted": self.evicted,
            "end_misses": self.end_misses,
            "frames_admitted": self.frames_admitted,
            "frames_skipped": self.frames_skipped,
            "open_frames": self.open_frames,
        }

    def __repr__(self):
        s = self.snapshot()
        return (f"<FlightRecorder entries={s['entries']}/{s['capacity']} "
                f"spans={s['spans_opened']} instants={s['instants']} "
                f"evicted={s['evicted']}>")


# ---------------------------------------------------------------------------
# metrics registry: one namespaced snapshot over every stats surface
# ---------------------------------------------------------------------------
def _scalar(v: Any):
    """Coerce numpy scalars to plain Python (the np.int64 -> json.dump
    TypeError class of bug); passthrough for everything json-native."""
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, (np.bool_,)):
        return bool(v)
    return v


def jsonable(obj: Any):
    """Recursively coerce a nested structure to json-serializable plain
    Python: numpy scalars become int/float/bool, numpy arrays become
    lists, tuples become lists, dict keys become strings."""
    if isinstance(obj, dict):
        return {str(k): jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [jsonable(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return [jsonable(v) for v in obj.tolist()]
    return _scalar(obj)


class MetricsRegistry:
    """Flat, namespaced metric snapshot with stable dotted names.

    Every value is a plain Python scalar (or string); nested component
    dicts flatten on ingest (``{"hubs": {0: {"state": ...}}}`` under
    prefix ``power`` becomes ``power.hubs.0.state``).  Iteration order
    is sorted by name, so two snapshots of the same run diff cleanly.
    """

    def __init__(self):
        self._vals: Dict[str, Any] = {}

    def set(self, name: str, value: Any):
        self._vals[name] = _scalar(value)

    def get(self, name: str, default=None):
        return self._vals.get(name, default)

    def ingest(self, prefix: str, mapping: dict):
        """Merge a component's stats dict under ``prefix``, flattening
        nested dicts into dotted names.  Lists and other non-scalar
        leaves are skipped — the registry holds metrics, not payloads."""
        for k, v in mapping.items():
            name = f"{prefix}.{k}" if prefix else str(k)
            if isinstance(v, dict):
                self.ingest(name, v)
            elif isinstance(v, (list, tuple, np.ndarray)):
                continue
            else:
                self.set(name, v)
        return self

    def names(self) -> List[str]:
        return sorted(self._vals)

    def snapshot(self) -> Dict[str, Any]:
        return {k: self._vals[k] for k in self.names()}

    def __len__(self):
        return len(self._vals)

    def __contains__(self, name):
        return name in self._vals

    def __getitem__(self, name):
        return self._vals[name]

    def __repr__(self):
        return f"<MetricsRegistry {len(self._vals)} metrics>"
