"""Learning-rate schedules: functions of the step counter.

The port of the reference's ``optim/schedules.py``.  Each schedule takes an
int step (or a 0-d tensor) and returns a 0-d fp32 tensor on the CPU,
computed in fp32 as the reference computes it; ``float()`` of it is the
rate.
"""
from __future__ import annotations

import math

import torch


def _f32(v) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32)


def cosine_warmup(peak: float, *, warmup: int, total: int, floor: float = 0.1):
    def lr(step):
        s = _f32(step)
        warm = peak * (s + 1.0) / max(warmup, 1)
        prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = floor * peak + (1 - floor) * peak * 0.5 * (
            1.0 + torch.cos(math.pi * prog))
        return torch.where(s < warmup, warm, cos)
    return lr


def constant(v: float):
    def lr(step):
        return _f32(v)
    return lr
