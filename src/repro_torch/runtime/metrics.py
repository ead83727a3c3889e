"""Streaming latency metrics for the dispatch hot path.

The engine records one sample per completed frame (end-to-end) and one per
stage visit, so the recorder must be O(1) per sample with no growing
state — a sorted-list percentile would turn the hot loop quadratic.

``StreamingHistogram`` keeps log-spaced bins (fixed count, geometric
edges): ``record`` is a single ``log`` + increment, quantiles walk the
(small, fixed) bin array and interpolate geometrically inside the winning
bin.  Relative quantile error is bounded by the bin width ratio
(``10**(1/bins_per_decade)``, ~7% at the default 32 bins/decade), which is
far below the 2x-scale effects the tail-latency benchmarks track.

The same class doubles as each lane's observed service-time distribution:
the hedge deadline is a quantile of it, so the estimator must stay cheap
enough to update on every ``_lane_done``.

``record_many`` is the bulk-ingest path for the vectorized engine core:
bin indices are computed with one ``np.log`` over the whole batch.
NumPy's SIMD log is *not* bitwise-identical to ``math.log`` (it can
differ in the last ulp), which only matters when a sample's scaled log
position lands exactly on a bin boundary — so the handful of elements
within 1e-9 of an integer position (the ulp of the scaled value is
~5e-13) are recomputed with the scalar formula.  Bin counts, ``count``,
``min`` and ``max`` are therefore bit-identical to repeated ``record``;
only ``total`` (and hence ``mean``) may differ by float-summation order,
which quantiles never read.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np

_LOG10 = math.log(10.0)


class StreamingHistogram:
    """Log-spaced histogram: O(1) record, O(bins) quantile, fixed memory."""

    __slots__ = ("lo", "hi", "bpd", "_log_lo", "_nbins", "counts",
                 "count", "total", "min", "max")

    def __init__(self, lo: float = 1e-6, hi: float = 1e5,
                 bins_per_decade: int = 32):
        assert lo > 0 and hi > lo
        self.lo = lo
        self.hi = hi
        self.bpd = bins_per_decade
        self._log_lo = math.log(lo) / _LOG10
        decades = math.log(hi / lo) / _LOG10
        self._nbins = int(math.ceil(decades * bins_per_decade)) + 1
        self.counts = np.zeros(self._nbins, dtype=np.int64)
        self.count = 0
        self.total = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def _bin(self, x: float) -> int:
        if x <= self.lo:
            return 0
        i = int((math.log(x) / _LOG10 - self._log_lo) * self.bpd)
        return min(i, self._nbins - 1)

    def _edge(self, i: int) -> float:
        return self.lo * 10.0 ** (i / self.bpd)

    def record(self, x: float):
        self.counts[self._bin(x)] += 1
        self.count += 1
        self.total += x
        if self.min is None or x < self.min:
            self.min = x
        if self.max is None or x > self.max:
            self.max = x

    def record_many(self, xs) -> None:
        """Bulk ingest: one vectorized bin pass for a batch of samples.

        Bin counts / count / min / max are bit-identical to calling
        ``record`` per element (boundary elements are recomputed with the
        scalar formula — see module docstring); ``total`` may differ in
        the last ulps from the sequential sum.
        """
        xs = np.asarray(xs, dtype=np.float64).ravel()
        if xs.size == 0:
            return
        if xs.size == 1:
            self.record(float(xs[0]))
            return
        pos = (np.log(np.maximum(xs, self.lo)) / _LOG10 - self._log_lo) \
            * self.bpd
        bins = np.minimum(pos.astype(np.int64), self._nbins - 1)
        np.maximum(bins, 0, out=bins)
        # boundary guard: np.log vs math.log ulp differences flip int()
        # only exactly at integer positions — redo those few scalars
        near = np.abs(pos - np.rint(pos)) < 1e-9
        if near.any():
            for j in np.nonzero(near)[0]:
                bins[j] = self._bin(float(xs[j]))
        np.add.at(self.counts, bins, 1)
        self.count += int(xs.size)
        self.total += float(xs.sum())
        mn = float(xs.min())
        mx = float(xs.max())
        if self.min is None or mn < self.min:
            self.min = mn
        if self.max is None or mx > self.max:
            self.max = mx

    def merge(self, other: "StreamingHistogram") -> "StreamingHistogram":
        """Fold ``other``'s samples into this histogram in place.

        Bin counts add exactly, so a merge is bit-identical (counts /
        count / min / max) to having recorded the concatenated sample
        streams into one histogram — per-lane and per-stage histograms
        aggregate into fleet-level views without re-recording.  Requires
        identical bin geometry; returns ``self`` for chaining."""
        if (self.lo, self.hi, self.bpd) != (other.lo, other.hi, other.bpd):
            raise ValueError(
                f"cannot merge histograms with different bin geometry: "
                f"(lo={self.lo}, hi={self.hi}, bpd={self.bpd}) vs "
                f"(lo={other.lo}, hi={other.hi}, bpd={other.bpd})")
        self.counts += other.counts
        self.count += other.count
        self.total += other.total
        if other.min is not None:
            self.min = other.min if self.min is None \
                else min(self.min, other.min)
        if other.max is not None:
            self.max = other.max if self.max is None \
                else max(self.max, other.max)
        return self

    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def quantile(self, q: float) -> float:
        """Interpolated quantile; 0.0 when empty (zero-completion safe)."""
        if not self.count:
            return 0.0
        if q <= 0.0:
            return self.min
        if q >= 1.0:
            return self.max
        rank = q * (self.count - 1)
        seen = 0
        for i, c in enumerate(self.counts):
            if not c:
                continue
            c = int(c)          # counts is int64 array: keep the math in
            if seen + c > rank:  # Python floats (JSON-serializable output)
                # mid-rank fraction: the k-th of c samples in a bin sits
                # at (k + 0.5)/c of the bin's span, so a single-count bin
                # interpolates to its geometric MIDPOINT instead of
                # pinning to the upper edge (which biased every sparse
                # low-q quantile a full bin high)
                frac = (rank - seen + 0.5) / c
                lo, hi = self._edge(i), self._edge(i + 1)
                est = lo * (hi / lo) ** min(max(frac, 0.0), 1.0)
                # exact extrema beat bin edges at the distribution ends
                return min(max(est, self.min), self.max)
            seen += c
        return self.max

    def p50(self) -> float:
        return self.quantile(0.50)

    def p95(self) -> float:
        return self.quantile(0.95)

    def p99(self) -> float:
        return self.quantile(0.99)

    def summary(self) -> dict:
        return {
            "count": self.count,
            "mean": self.mean(),
            "p50": self.p50(),
            "p95": self.p95(),
            "p99": self.p99(),
            "min": self.min if self.min is not None else 0.0,
            "max": self.max if self.max is not None else 0.0,
        }

    def __repr__(self):
        s = self.summary()
        return (f"<StreamingHistogram n={s['count']} mean={s['mean']:.4g} "
                f"p50={s['p50']:.4g} p99={s['p99']:.4g}>")
