"""Deterministic, shard-aware streaming data: token batches and frames.

A copy of the reference's ``data/pipeline.py``.  Batch t is a pure function
of (seed, step, shard), drawn with numpy, so a restarted job replays the
exact stream with no state files, each data-parallel rank draws only its
slice, and the port and the reference see the same tokens and pixels.
``Prefetcher`` keeps a bounded queue of ready batches filled by a
background thread; ``close()`` stops and joins it.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    vocab_size: int = 32000
    seq_len: int = 512
    global_batch: int = 8
    n_shards: int = 1
    shard: int = 0

    @property
    def local_batch(self) -> int:
        if self.global_batch % self.n_shards:
            raise ValueError(f"global batch {self.global_batch} does not "
                             f"split over {self.n_shards} shards")
        return self.global_batch // self.n_shards


class TokenStream:
    """Synthetic LM stream: step-indexed, deterministic, shardable.

    Tokens follow a skewed unigram distribution with short-range structure
    (next token correlated with previous) so models actually learn and
    loss curves are meaningful in examples/tests.
    """

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def batch_at(self, step: int) -> dict:
        c = self.cfg
        ss = np.random.SeedSequence([c.seed, step, c.shard])
        rng = np.random.default_rng(ss)
        B, S, V = c.local_batch, c.seq_len, c.vocab_size
        base = rng.zipf(1.5, size=(B, S + 1)).astype(np.int64)
        tok = np.minimum(base, V - 1).astype(np.int32)
        # short-range structure: token t+1 echoes token t half the time
        echo = rng.random((B, S)) < 0.5
        for i in range(1, S + 1):
            tok[:, i] = np.where(echo[:, i - 1], (tok[:, i - 1] + 1) % V,
                                 tok[:, i])
        return {"tokens": tok[:, :-1], "labels": tok[:, 1:].copy()}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class FrameStream:
    """Synthetic camera frames (H, W, 3) for the biometric pipelines."""

    def __init__(self, seed: int = 0, hw=(224, 224)):
        self.seed, self.hw = seed, hw

    def frame_at(self, i: int) -> np.ndarray:
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, i]))
        h, w = self.hw
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        cx, cy = rng.uniform(0.2, 0.8, 2) * (w, h)
        r = rng.uniform(0.1, 0.3) * min(h, w)
        blob = np.exp(-(((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * r * r)))
        img = rng.normal(0.5, 0.1, (h, w, 3)).astype(np.float32)
        img += blob[..., None] * rng.uniform(0.3, 0.8, 3).astype(np.float32)
        return np.clip(img, 0, 1)


class Prefetcher:
    """Bounded background prefetch over any step-indexed source: ``next()``
    gives (step, batch) from ``start_step`` on."""

    def __init__(self, source, start_step: int = 0, depth: int = 2):
        self.source = source
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        s = self._step
        while not self._stop.is_set():
            try:
                self.q.put((s, self.source.batch_at(s)), timeout=0.2)
                s += 1
            except queue.Full:
                continue

    def next(self):
        return self.q.get()

    def close(self):
        """Stop the thread and join it; the queued batches are dropped."""
        self._stop.set()
        while self._thread.is_alive():
            while not self.q.empty():
                self.q.get_nowait()
            self._thread.join(timeout=0.2)
