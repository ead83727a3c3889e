"""Async checkpointing with atomic commit, garbage collection and restore.

The port of the reference's ``checkpoint/store.py`` on one process.  A
snapshot is a tree of tensors (dicts, lists, tuples and ``QTensor``s, such
as ``{"p": parameters by name, "o": optimizer state}``) flattened to
"/"-joined keys.  ``save`` copies every value to the host under the caller,
so training may go on updating its tensors in place, and writes on a
background thread: a temp directory, then one atomic rename to
``step_<step>``, with a manifest of the step and keys.  At most one save is
in flight (the next ``save`` joins the last), the newest ``keep`` steps are
kept, and ``restore`` reads the newest *committed* step, so a crash
mid-save never corrupts the restore point.

The on-disk format is the port's own: the values in one ``torch.save``
file (``shards.pt``), read back memory-mapped with ``weights_only``; it
does not read the reference's ``shards.npz``.  A DTensor (a sharded run's
parameter or state) is saved as its full tensor, gathered from its shards
(a collective: every rank of its mesh saves), and restored as a plain
tensor, so one format serves every mesh; ``runtime.elastic``'s
``recover`` re-distributes it onto the new one.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Optional

import torch

from repro_torch.optim.quant import QTensor

SHARDS = "shards.pt"


def _flatten(tree, prefix: str = "") -> dict:
    """{key: tensor} of a tree, keys the "/"-joined path."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    elif isinstance(tree, QTensor):
        items = (("q", tree.q), ("scale", tree.scale))
    elif isinstance(tree, torch.Tensor):
        return {prefix: tree}
    else:
        raise TypeError(f"checkpoint: cannot store {type(tree).__name__} "
                        f"at {prefix!r}")
    out = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _unflatten(like, data: dict, prefix: str = ""):
    """``like``'s tree with each tensor taken from ``data`` by its key, on
    the like leaf's device and in its dtype."""
    key = lambda k: f"{prefix}/{k}" if prefix else str(k)  # noqa: E731
    if isinstance(like, dict):
        return {k: _unflatten(v, data, key(k)) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, data, key(i))
                          for i, v in enumerate(like))
    if isinstance(like, QTensor):
        return QTensor(q=_unflatten(like.q, data, key("q")),
                       scale=_unflatten(like.scale, data, key("scale")),
                       shape=like.shape)
    # a DTensor ``like`` takes the whole tensor, as a plain one
    return data[prefix].to(device=like.device, dtype=like.dtype, copy=True)


class CheckpointStore:
    def __init__(self, root: str, keep: int = 3):
        self.root = root
        self.keep = keep
        os.makedirs(root, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None
        self.save_count = 0

    # -- save -----------------------------------------------------------------
    def save(self, step: int, tree: Any, *, block: bool = False):
        """Snapshot ``tree`` at ``step``.  Async by default; at most one
        save in flight (joins the previous one first)."""
        self.wait()
        # host copies under the caller: the values as of this call (a
        # DTensor whole)
        from repro_torch.sharding import full_tensor
        flat = {k: full_tensor(v.detach()).to("cpu", copy=True)
                for k, v in _flatten(tree).items()}
        t = threading.Thread(target=self._write, args=(step, flat),
                             daemon=True)
        t.start()
        self._thread = t
        if block:
            self.wait()

    def _write(self, step: int, flat: dict):
        try:
            tmp = os.path.join(self.root, f".tmp-{step}-{os.getpid()}")
            final = os.path.join(self.root, f"step_{step:010d}")
            os.makedirs(tmp, exist_ok=True)
            torch.save(flat, os.path.join(tmp, SHARDS))
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump({"step": step, "keys": sorted(flat),
                           "time": time.time()}, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)  # atomic commit
            self.save_count += 1
            self._gc()
        except Exception as e:  # re-raised by wait() in the caller
            self._error = e

    def wait(self):
        """Join the save in flight; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            e, self._error = self._error, None
            raise RuntimeError("checkpoint save failed") from e

    def _gc(self):
        for s in self.steps()[: -self.keep]:
            shutil.rmtree(os.path.join(self.root, f"step_{s:010d}"),
                          ignore_errors=True)

    # -- restore -------------------------------------------------------------
    def steps(self):
        out = []
        for d in os.listdir(self.root):
            if d.startswith("step_") and os.path.exists(
                    os.path.join(self.root, d, "manifest.json")):
                out.append(int(d.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, like: Any, step: Optional[int] = None):
        """Restore into the structure of ``like`` (a tree of tensors, whose
        devices and dtypes the restored leaves take).  Returns (step,
        tree)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {self.root}")
        path = os.path.join(self.root, f"step_{step:010d}", SHARDS)
        data = torch.load(path, map_location="cpu", mmap=True,
                          weights_only=True)
        missing = set(_flatten(like)) - set(data)
        if missing:
            raise KeyError(f"checkpoint missing keys: {sorted(missing)[:5]}")
        return step, _unflatten(like, data)
