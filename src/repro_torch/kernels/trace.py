"""Whether the kernels' operators take meta tensors: the mesh dry run.

The dry run (``launch/dryrun.py``) traces a step on meta tensors, on a
host with no card, and must record the kernels' operators
(``repro_torch::flash_attention``, ``repro_torch::mamba2_ssd`` and their
backwards), which then run their fake implementations.  Inside
``meta_operators()`` the wrappers send meta tensors to those operators;
everywhere else a meta tensor raises, as any device without a kernel does.
"""
from __future__ import annotations

import contextlib
import threading

_state = threading.local()


@contextlib.contextmanager
def meta_operators():
    prev = getattr(_state, "on", False)
    _state.on = True
    try:
        yield
    finally:
        _state.on = prev


def operator_device(device) -> bool:
    """Whether a tensor on ``device`` goes to the kernel's operator: a CUDA
    tensor always, a meta one inside ``meta_operators()``."""
    return device.type == "cuda" or (device.type == "meta" and
                                     getattr(_state, "on", False))


def tracing_meta(device) -> bool:
    """Whether a tensor on ``device`` is being traced (a meta tensor inside
    ``meta_operators()``): a sequential scan then traces one step for all
    of them (``repeated``)."""
    return device.type == "meta" and getattr(_state, "on", False)


@contextlib.contextmanager
def repeated(n: int):
    """Operators run inside stand for ``n`` runs of themselves: the dry
    run's counter counts each ``n`` times (a scan's step traced once for
    its trip count, as the reference's HLO statistics multiply a loop body
    by its trip count)."""
    prev = getattr(_state, "times", 1)
    _state.times = prev * n
    try:
        yield
    finally:
        _state.times = prev


def times() -> int:
    """How many runs each operator traced now stands for."""
    return getattr(_state, "times", 1)
