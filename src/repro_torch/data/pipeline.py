"""Deterministic synthetic frame source for the biometric pipelines.

A copy of ``FrameStream`` from the reference's ``data/pipeline.py``:
frame ``i`` is a pure function of ``(seed, i)``, drawn with numpy, so the
port and the reference see the same pixels.
"""
from __future__ import annotations

import numpy as np


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
