"""Elastic training controller: node failure == cartridge removal.

The port of the reference's ``runtime/elastic.py`` onto
``torch.distributed``.  The CHAMP insight applied to training scale:
membership changes are routine events, not crashes.  The controller owns
the (data, model) mesh factorization over however many *healthy* ranks
exist; on failure or join it (1) pauses, (2) re-factorizes the mesh to the
largest supported shape, a ``DeviceMesh`` over the healthy ranks, (3)
restores parameters and optimizer state from the latest committed
checkpoint re-distributed onto the new mesh, (4) replays the data stream
from the restored step (deterministic step-indexed pipeline => no sample
loss or duplication), exactly like VDiSK's pause -> reconfigure -> replay
cycle.

``ranks`` are ranks of the default process group, which every one of them
has joined: making a mesh over a subset is a collective of the whole
group, and a rank left out of it sees ``get_coordinate() is None``.  The
checkpoint holds each tensor whole (``CheckpointStore`` gathers a
DTensor), so a state saved on one mesh restores onto any other.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional


@dataclass
class ElasticEvent:
    t_step: int
    kind: str           # "fail" | "join" | "remesh" | "restore" | "paused"
    detail: str = ""


def largest_mesh(n_devices: int, model_parallel: int) -> tuple:
    """(data, model) for the largest usable power-of-two data axis.
    ``(0, 0)`` when no devices remain — the all-failed case must degrade
    upstream, not divide by zero here."""
    if n_devices <= 0:
        return (0, 0)
    model = min(model_parallel, n_devices)
    data = n_devices // model
    data = 2 ** int(math.log2(data)) if data else 1
    return (data, model)


class ElasticController:
    def __init__(self, ranks: List[int], *, model_parallel: int = 1,
                 checkpoint_store=None, device_type: str = "cuda"):
        self.all_devices = list(ranks)
        self.healthy = set(range(len(ranks)))
        self.model_parallel = model_parallel
        self.store = checkpoint_store
        self.device_type = device_type
        self.events: List[ElasticEvent] = []
        self.mesh = None
        self.remesh(step=0)

    # -- membership -------------------------------------------------------------
    def fail(self, idx: int, step: int):
        self.healthy.discard(idx)
        self.events.append(ElasticEvent(step, "fail", f"device {idx}"))

    def join(self, idx: int, step: int):
        self.healthy.add(idx)
        self.events.append(ElasticEvent(step, "join", f"device {idx}"))

    # -- re-meshing ---------------------------------------------------------------
    @property
    def paused(self) -> bool:
        """True while no healthy devices exist (training cannot proceed;
        the next ``join`` + ``remesh`` resumes)."""
        return self.mesh is None

    def remesh(self, step: int):
        import torch
        from torch.distributed.device_mesh import DeviceMesh
        devs = [self.all_devices[i] for i in sorted(self.healthy)]
        if not devs:
            # every device failed: degrade to a paused state instead of
            # crashing on a 0-device mesh (0 // 0, log2(0)); state stays
            # committed in the checkpoint store, so a later join picks up
            # exactly where the last committed step left off
            self.mesh = None
            self.events.append(ElasticEvent(
                step, "paused",
                "0 healthy devices; training paused awaiting join"))
            return None
        data, model = largest_mesh(len(devs), self.model_parallel)
        use = devs[: data * model]
        self.mesh = DeviceMesh(self.device_type,
                               torch.tensor(use).reshape(data, model),
                               mesh_dim_names=("data", "model"))
        self.events.append(ElasticEvent(
            step, "remesh", f"{data}x{model} over {len(use)} devices"))
        return self.mesh

    # -- recovery ----------------------------------------------------------------
    def recover(self, like, step_hint: Optional[int] = None):
        """Restore the latest committed state onto the *current* mesh.

        ``like`` is a tree of tensors: DTensors carry the placements (on the
        new mesh) each leaf takes, plain tensors their device and dtype.
        Returns (step, state), each DTensor leaf re-distributed from the
        whole tensor the checkpoint holds."""
        from torch.distributed.tensor import DTensor, distribute_tensor
        assert self.store is not None
        step, state = self.store.restore(like, step_hint)

        def put(x, like_leaf):
            if isinstance(like_leaf, dict):
                return {k: put(x[k], v) for k, v in like_leaf.items()}
            if isinstance(like_leaf, (list, tuple)):
                return type(like_leaf)(put(a, b) for a, b in
                                       zip(x, like_leaf))
            if isinstance(like_leaf, DTensor):
                return distribute_tensor(x, like_leaf.device_mesh,
                                         like_leaf.placements)
            return x

        state = put(state, like)
        self.events.append(ElasticEvent(step, "restore", f"step {step}"))
        return step, state
