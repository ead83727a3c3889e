"""Event queues for the StreamEngine's discrete-event core.

The engine's hot loop is push/pop of timestamped events; with lane groups
and micro-batch retries a large scenario keeps tens of thousands of events
queued, so the pop discipline dominates simulated events/sec.

``HeapEventQueue`` — the engine core: O(log n) push/pop via ``heapq``,
with a monotonically increasing sequence number so events at equal
timestamps pop in FIFO order (deterministic replay).  The engine has
always popped from a heap; this module makes the queue a first-class,
injectable component.

Cancellation.  ``push`` returns a handle and ``cancel(handle)`` kills the
event before it fires — the hedged-dispatch path arms a deadline event
per service cycle and cancels it when the lane finishes on time, which is
the common case, so cancellation must be cheap.  The heap uses lazy
deletion (an O(1) set insert; dead entries are skipped when they surface
at the heap top), keeping push/pop asymptotics intact.  Under sustained
hedging the dead set would otherwise grow without bound and every
push/pop would pay log(dead + live); ``cancel`` therefore compacts the
heap (rebuild excluding dead entries + re-heapify) whenever dead entries
outnumber live ones.  ``compactions`` counts rebuilds and ``dead_peak``
tracks the worst dead-set size ever reached, so a regression in the
threshold logic is observable.

Cohorts.  ``pop_cohort`` drains *every* live event at the earliest
timestamp in one call (seq order — identical to repeated ``pop``).  The
epoch-stepped engine core uses it to amortize queue overhead across a
whole wall-clock instant.  Drained entries enter a *pending* state:
``cancel`` still works on them until the engine commits each one with
``fire(handle)``, which is what preserves same-timestamp cancellation
semantics (e.g. a fault killing a completion scheduled for the same
instant).  ``fire`` returns False for a cohort member cancelled after the
drain, and only fired events advance the ``popped`` counter — so
events/sec accounting matches the pop-per-event core exactly.

``ListEventQueue`` — a reference implementation of the naive O(n)
linear-scan-for-minimum discipline.  It never shipped as the engine
core; it exists so the engine bench can quantify, on the identical
workload, what the heap core buys (``BENCH_engine.json`` tracks the
heap-vs-list events/sec ratio, so a future regression of the engine's
event discipline is visible against a fixed yardstick).  Pop order is
identical to the heap queue (min timestamp, FIFO on ties), only the
asymptotics differ — do not use it outside benchmarks.
"""
from __future__ import annotations

import heapq
import itertools
from typing import Any, Callable, List, Tuple

Event = Tuple[float, int, Callable, tuple]


class HeapEventQueue:
    """Binary-heap priority queue: O(log n) push/pop, FIFO on time ties,
    O(1) lazy cancellation with threshold compaction."""

    def __init__(self):
        self._heap: list = []
        self._seq = itertools.count()
        self._live: set = set()        # handles pushed and not fired/killed
        self._dead: set = set()        # handles cancelled but not yet popped
        self._pending: set = set()     # drained by pop_cohort, not yet fired
        self._killed: set = set()      # cancelled while pending
        self.pushed = 0
        self.popped = 0
        self.cancelled = 0
        self.compactions = 0
        self.dead_peak = 0

    def push(self, t: float, fn: Callable, args: tuple) -> int:
        handle = next(self._seq)
        heapq.heappush(self._heap, (t, handle, fn, args))
        self._live.add(handle)
        self.pushed += 1
        return handle

    def cancel(self, handle: int) -> bool:
        """Kill a pending event.  Returns False if it already fired (or was
        already cancelled) — callers may cancel unconditionally.  O(1)
        amortized: the heap entry dies lazily, and the heap is rebuilt
        without dead entries once they outnumber live ones."""
        if handle in self._pending:
            # drained by pop_cohort but not yet fired: kill it in place
            self._pending.discard(handle)
            self._killed.add(handle)
            self.cancelled += 1
            return True
        if handle not in self._live:
            return False
        self._live.discard(handle)
        self._dead.add(handle)
        self.cancelled += 1
        if len(self._dead) > self.dead_peak:
            self.dead_peak = len(self._dead)
        if len(self._dead) > len(self._heap) - len(self._dead):
            self._compact()
        return True

    def _compact(self):
        """Rebuild the heap without dead entries (threshold compaction)."""
        self._heap = [ev for ev in self._heap if ev[1] not in self._dead]
        heapq.heapify(self._heap)
        self._dead.clear()
        self.compactions += 1

    def _drop_dead(self):
        while self._heap and self._heap[0][1] in self._dead:
            self._dead.discard(heapq.heappop(self._heap)[1])

    def pop(self) -> Event:
        """Pop the earliest live event.  Raises a descriptive
        ``IndexError`` on an exhausted queue *without* touching the
        ``popped`` counter — a failed pop must not corrupt the
        events/sec stats ``BENCH_engine.json`` tracks."""
        self._drop_dead()
        if not self._heap:
            raise IndexError("pop from empty HeapEventQueue")
        ev = heapq.heappop(self._heap)
        self.popped += 1
        self._live.discard(ev[1])
        return ev

    def pop_cohort(self) -> List[Event]:
        """Drain every live event at the earliest timestamp, in seq order
        (identical to repeated ``pop`` at that instant).  Entries move to
        a pending state: ``cancel`` still kills them until ``fire`` is
        called per entry.  ``popped`` advances only on ``fire``."""
        self._drop_dead()
        if not self._heap:
            raise IndexError("pop_cohort from empty HeapEventQueue")
        heap, dead = self._heap, self._dead
        t0 = heap[0][0]
        out: List[Event] = []
        while heap and heap[0][0] == t0:
            ev = heapq.heappop(heap)
            h = ev[1]
            if h in dead:
                dead.discard(h)
                continue
            self._live.discard(h)
            self._pending.add(h)
            out.append(ev)
        return out

    def fire(self, handle: int) -> bool:
        """Commit one ``pop_cohort`` entry for execution.  Returns False
        (and counts nothing) if the entry was cancelled after the drain."""
        if handle in self._pending:
            self._pending.discard(handle)
            self.popped += 1
            return True
        self._killed.discard(handle)
        return False

    def peek_time(self) -> float:
        self._drop_dead()
        if not self._heap:
            raise IndexError("peek_time on empty HeapEventQueue")
        return self._heap[0][0]

    def stats(self) -> dict:
        """Lifetime counters (the ``engine.events.*`` metrics
        namespace): fed into the metrics registry at report time so the
        queue's health — cancellation pressure, compaction churn — is
        visible next to the engine's own counters."""
        return {"pushed": self.pushed, "popped": self.popped,
                "cancelled": self.cancelled,
                "compactions": self.compactions,
                "dead_peak": self.dead_peak}

    def __len__(self) -> int:
        return len(self._heap) - len(self._dead)


class ListEventQueue:
    """The linear-scan baseline: append on push, scan for the minimum on
    pop (and on peek).  Same pop order + cancellation + cohort semantics
    as ``HeapEventQueue``; O(n) per event instead of O(log n)."""

    def __init__(self):
        self._q: list = []
        self._seq = itertools.count()
        self._pending: set = set()
        self._killed: set = set()
        self.pushed = 0
        self.popped = 0
        self.cancelled = 0
        self.compactions = 0   # API parity: eager removal never compacts
        self.dead_peak = 0

    def push(self, t: float, fn: Callable, args: tuple) -> int:
        handle = next(self._seq)
        self._q.append((t, handle, fn, args))
        self.pushed += 1
        return handle

    def cancel(self, handle: int) -> bool:
        if handle in self._pending:
            self._pending.discard(handle)
            self._killed.add(handle)
            self.cancelled += 1
            return True
        for ev in self._q:
            if ev[1] == handle:
                self._q.remove(ev)
                self.cancelled += 1
                return True
        return False

    def pop(self) -> Event:
        if not self._q:                # mirror HeapEventQueue's contract
            raise IndexError("pop from empty ListEventQueue")
        # seq numbers are unique, so tuple comparison never reaches fn
        ev = min(self._q)
        self._q.remove(ev)
        self.popped += 1
        return ev

    def pop_cohort(self) -> List[Event]:
        if not self._q:
            raise IndexError("pop_cohort from empty ListEventQueue")
        t0 = min(self._q)[0]
        out = sorted(ev for ev in self._q if ev[0] == t0)
        for ev in out:
            self._q.remove(ev)
            self._pending.add(ev[1])
        return out

    def fire(self, handle: int) -> bool:
        if handle in self._pending:
            self._pending.discard(handle)
            self.popped += 1
            return True
        self._killed.discard(handle)
        return False

    def peek_time(self) -> float:
        if not self._q:
            raise IndexError("peek_time on empty ListEventQueue")
        return min(self._q)[0]

    def stats(self) -> dict:
        return {"pushed": self.pushed, "popped": self.popped,
                "cancelled": self.cancelled,
                "compactions": self.compactions,
                "dead_peak": self.dead_peak}

    def __len__(self) -> int:
        return len(self._q)
