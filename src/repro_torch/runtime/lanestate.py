"""Lane-id-indexed state arrays for the vectorized engine core.

The epoch-stepped ``StreamEngine`` core replaces the per-dispatch linear
scan over ``_Lane`` objects with an argmin over NumPy arrays.  For that
to be exact, every scalar the scan used to read from lane attributes —
EWMA service estimate, queue depth, busy/held occupancy, warm-up
``ready_at`` — must live in arrays that are *always* current.  This
module owns those arrays; ``_Lane`` objects stay the API for the control
path (hot-swap, chaos recovery, migration) and write through on every
mutation:

- ``LaneStateBank`` — a growable structure-of-arrays slab keyed by lane
  id (``lid``).  Lane ids are recycled through a free list so a
  long-lived engine with hot-swap churn keeps the slab dense.
- ``TrackedDeque`` — a ``collections.deque`` that mirrors its length
  into ``bank.qlen[lid]`` after every mutating call, so queue depth is
  readable as an array without touching lane objects.
- ``MeterBank`` — the same slab pattern for ``PowerGovernor`` lane
  meters (power draw, duty-cycle integration state), so per-lane energy
  integrates as one array expression at report time.

Write-through keeps both views bitwise equal: the arrays store the very
same float64 the attribute holds, so a vectorized ``(backlog+1)*est_s``
is bit-identical to the scalar expression, and the argmin fast path can
be an *exact* replacement for ``min()`` (NumPy's argmin returns the
first minimal index, matching ``min``'s first-minimal tie-break).
"""
from __future__ import annotations

from collections import deque
from typing import Dict, List

import numpy as np


class SoABank:
    """Growable structure-of-arrays with slot recycling.

    Subclasses declare ``FIELDS_F64`` / ``FIELDS_I64`` as
    ``{name: default}`` dicts; each becomes a same-length array
    attribute.  ``alloc`` returns a row id (smallest recycled id first),
    ``release`` resets the row to defaults and recycles it.  Growth
    doubles capacity and *replaces* the arrays — consumers must read
    arrays through the bank attribute, never cache them across allocs.
    """

    FIELDS_F64: Dict[str, float] = {}
    FIELDS_I64: Dict[str, int] = {}

    def __init__(self, capacity: int = 64):
        assert capacity > 0
        self._cap = capacity
        self._top = 0
        self._free: List[int] = []
        for name, default in self.FIELDS_F64.items():
            setattr(self, name, np.full(capacity, default, dtype=np.float64))
        for name, default in self.FIELDS_I64.items():
            setattr(self, name, np.full(capacity, default, dtype=np.int64))

    def _grow(self):
        new_cap = self._cap * 2
        for fields in (self.FIELDS_F64, self.FIELDS_I64):
            for name, default in fields.items():
                old = getattr(self, name)
                grown = np.full(new_cap, default, dtype=old.dtype)
                grown[: self._cap] = old
                setattr(self, name, grown)
        self._cap = new_cap

    def _reset(self, row: int):
        for fields in (self.FIELDS_F64, self.FIELDS_I64):
            for name, default in fields.items():
                getattr(self, name)[row] = default

    def alloc(self) -> int:
        if self._free:
            row = self._free.pop()
            self._reset(row)
            return row
        if self._top == self._cap:
            self._grow()
        row = self._top
        self._top += 1
        return row

    def release(self, row: int):
        self._reset(row)
        self._free.append(row)

    @property
    def capacity(self) -> int:
        return self._cap

    def __len__(self) -> int:
        return self._top - len(self._free)


class LaneStateBank(SoABank):
    """Per-lane dispatch state, indexed by lane id.

    ``qlen + busy + heldn`` is exactly ``_Lane.backlog()``; ``est_s`` and
    ``ready_at`` mirror the attributes of the same name.  ``hub`` mirrors
    the lane's hub index (-1 for the default hub) for future fabric-aware
    vector paths.
    """

    FIELDS_F64 = {"est_s": 0.0, "ready_at": 0.0}
    FIELDS_I64 = {"qlen": 0, "busy": 0, "heldn": 0, "hub": -1}


class MeterBank(SoABank):
    """Per-lane power-meter state for ``PowerGovernor``.

    ``detached_at`` < 0 means the meter is still attached; ``energy``
    integrates idle floor + active uplift for a set of rows in one array
    expression — elementwise float64, so each lane's joules are bitwise
    identical to the scalar formula.
    """

    FIELDS_F64 = {"power_w": 0.0, "idle_w": 0.0, "attached_at": 0.0,
                  "detached_at": -1.0, "active_s": 0.0, "uplift_w": 0.0}
    FIELDS_I64 = {"hub": 0, "cycles": 0}

    def energy(self, t: float, rows: np.ndarray) -> np.ndarray:
        """Joules per row at time ``t`` (attach-to-now idle floor plus
        accumulated active uplift), vectorized."""
        det = self.detached_at[rows]
        end = np.where(det >= 0.0, det, t)
        elapsed = np.maximum(end - self.attached_at[rows], 0.0)
        return (elapsed * self.idle_w[rows]
                + self.active_s[rows] * (self.power_w[rows]
                                         - self.idle_w[rows]))


class TrackedDeque(deque):
    """A deque that mirrors ``len(self)`` into ``bank.qlen[lid]`` after
    every mutating operation, so the vectorized dispatch path reads
    queue depth from an array instead of calling ``len`` per lane."""

    def __init__(self, bank: LaneStateBank, lid: int, iterable=()):
        super().__init__(iterable)
        self._bank = bank
        self._lid = lid
        bank.qlen[lid] = len(self)

    def _sync(self):
        self._bank.qlen[self._lid] = len(self)

    def append(self, x):
        super().append(x)
        self._sync()

    def appendleft(self, x):
        super().appendleft(x)
        self._sync()

    def pop(self):
        v = super().pop()
        self._sync()
        return v

    def popleft(self):
        v = super().popleft()
        self._sync()
        return v

    def clear(self):
        super().clear()
        self._sync()

    def remove(self, x):
        super().remove(x)
        self._sync()

    def extend(self, xs):
        super().extend(xs)
        self._sync()

    def extendleft(self, xs):
        super().extendleft(xs)
        self._sync()

    def insert(self, i, x):
        super().insert(i, x)
        self._sync()

    def __delitem__(self, i):
        super().__delitem__(i)
        self._sync()
