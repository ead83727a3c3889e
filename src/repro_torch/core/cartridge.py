"""Capability cartridges: self-describing, hot-swappable AI stages.

A ``Cartridge`` binds (1) a typed consume/produce contract, (2) an eager
PyTorch compute fn with its params (an ``nn.Module`` or tensors) and the
torch device it runs on, (3) a *device model* (service time, bytes moved,
power) used by the bus simulator and power accounting, and (4) lifecycle
hooks (load/warmup = the paper's "reloading the model on the stick", which
dominates the 2 s re-insert pause).

``capability_id`` mirrors the paper's predefined per-function codes.
"""
from __future__ import annotations

import copy
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.core import messages as msg


@dataclass
class DeviceModel:
    """Calibrated accelerator model (per NCS2/Coral/cartridge type)."""
    name: str = "ncs2"
    service_s: float = 1 / 15.0  # per-frame compute time at batch 1
    host_overhead_s: float = 0.004  # per-transfer host CPU dispatch cost
    power_w: float = 1.8  # draw while running (paper §4.3: 1-2 W)
    idle_w: float = 0.3
    load_s: float = 1.5  # model (re)load on insert — bulk of the 2 s pause
    # Marginal service cost of each extra frame in a micro-batch, as a
    # fraction of service_s (activations stream through the on-stick model
    # back-to-back, so per-frame dispatch overhead amortizes).  1.0 = no
    # batching benefit.
    batch_marginal: float = 0.7
    # Heavy-tail service jitter: with probability ``jitter_p`` a service
    # cycle stalls to ``jitter_mult x`` its nominal time (USB re-enumeration
    # hiccups, on-stick thermal throttling — the stragglers that hedged
    # dispatch exists to absorb).  The draw is a deterministic hash of
    # (lane, frame seq), so simulations stay replayable.  Defaults off:
    # calibrated Table 1 devices are jitter-free.
    jitter_p: float = 0.0
    jitter_mult: float = 10.0
    # Thermal calibration (§4.3 power governor).  ``therm_tau_s`` is the
    # stick's thermal time constant: the smoothing horizon over which the
    # governor estimates a hub's electrical draw (enclosure heat mass —
    # a bare USB stick in free air settles within ~a second).
    # ``min_duty`` is the deepest duty cycle throttling may impose before
    # the governor parks the hub instead: below it the per-frame latency
    # stretch stops being worth the trickle of throughput.
    therm_tau_s: float = 1.0
    min_duty: float = 0.2


class Cartridge:
    """Base class. Subclasses set contract + fn; instances are hot-swappable."""

    capability_id: int = 0
    name: str = "cartridge"
    consumes: msg.MessageSpec = msg.MessageSpec(msg.IMAGE_FRAME)
    produces: msg.MessageSpec = msg.MessageSpec(msg.IMAGE_FRAME)

    def __init__(self, params: Any = None, device: Optional[DeviceModel] = None,
                 name: Optional[str] = None, torch_device="cpu"):
        self.params = params
        self.device = device or DeviceModel()
        # where the compute runs; ``device`` is the calibrated stick model
        self.torch_device = torch.device(torch_device)
        if name:
            self.name = name
        self._fn = None
        self._loaded = False
        self._clone_seq = 0
        self.stats = {"processed": 0, "busy_s": 0.0}

    # -- lifecycle ----------------------------------------------------------
    def load(self) -> float:
        """Flash/compile the cartridge. Returns load time (s)."""
        t0 = time.perf_counter()
        self._fn = self.fn               # eager: nothing to compile
        self.warmup()
        self._loaded = True
        return time.perf_counter() - t0

    def unload(self):
        self._fn = None
        self._loaded = False

    def warmup(self):
        ex = self.example_input()
        if ex is not None:
            with torch.no_grad():
                self._fn(self.params, ex)
            self._sync()

    def _sync(self):
        """Wait for queued device work (the eager analogue of JAX's
        ``block_until_ready``): service times are wall-clock."""
        if self.torch_device.type == "cuda":
            torch.cuda.synchronize(self.torch_device)

    def example_input(self):
        sh = self.consumes.shape
        if sh is None or any(s is None for s in sh):
            return None
        dt = self.consumes.dtype or np.float32
        return torch.from_numpy(np.zeros(sh, dt)).to(self.torch_device)

    # -- replication ---------------------------------------------------------
    def clone(self, name: Optional[str] = None,
              device: Optional[DeviceModel] = None) -> "Cartridge":
        """A replica of this cartridge on another physical device.

        Shares the (immutable) params and compiled fn — the same bitstream
        flashed onto a second stick — but carries its own identity,
        runtime stats, and **its own DeviceModel copy**: two sticks never
        share a calibration record, so per-device mutation (thermal
        state, calibration drift) cannot silently alias across sibling
        lanes.  Pass ``device`` to flash it onto a *different*
        accelerator type (heterogeneous lane group: e.g. an NCS2 primary
        with Coral replicas); the contract stays identical, only the
        calibrated service model changes, and the engine's weighted
        dispatcher uses it as each lane's seed estimate.

        Auto-names are deterministic *per parent* (``name#r1``,
        ``name#r2``, ...), not drawn from a process-global counter, so
        the engine's crc32(lane, seq) jitter draws replay identically
        no matter what else the process cloned first.
        """
        self._clone_seq += 1
        rep = copy.copy(self)
        rep.stats = {"processed": 0, "busy_s": 0.0}
        rep._clone_seq = 0             # the replica numbers its own clones
        rep.name = name or f"{self.name}#r{self._clone_seq}"
        rep.device = copy.copy(device if device is not None else self.device)
        return rep

    # -- compute ------------------------------------------------------------
    def fn(self, params, x):  # override
        raise NotImplementedError

    def process(self, m: msg.Message) -> msg.Message:
        assert self._loaded, f"{self.name}: process() before load()"
        t0 = time.perf_counter()
        with torch.no_grad():
            out = self._fn(self.params, m.payload)
        self._sync()
        self.stats["busy_s"] += time.perf_counter() - t0
        self.stats["processed"] += 1
        return m.with_payload(out, self.produces.kind)

    def process_batch(self, ms: list) -> list:
        """Service one engine micro-batch.  Default is frame-at-a-time;
        batched stage types (e.g. the watchlist match stage) override this
        to coalesce the whole batch into a single kernel dispatch."""
        return [self.process(m) if m.payload is not None else m for m in ms]

    # -- handshake (paper §3.2: capability ID + data format) -----------------
    def handshake(self) -> dict:
        return {
            "capability_id": self.capability_id,
            "name": self.name,
            "consumes": self.consumes,
            "produces": self.produces,
            "device": self.device.name,
        }

    def __repr__(self):
        return (f"<{type(self).__name__} {self.name} "
                f"{self.consumes.describe()}->{self.produces.describe()}>")


class FnCartridge(Cartridge):
    """Wrap an arbitrary (params, x) -> y torch fn as a cartridge."""

    def __init__(self, name, fn, consumes, produces, params=None,
                 capability_id=99, device=None, torch_device="cpu"):
        self._user_fn = fn
        self.capability_id = capability_id
        super().__init__(params=params, device=device, name=name,
                         torch_device=torch_device)
        self.consumes = consumes
        self.produces = produces

    def fn(self, params, x):
        return self._user_fn(params, x)


class PassThrough(Cartridge):
    """VDiSK's bridge stage: inserted when a removed cartridge's gap is
    type-compatible (paper §2.3: 'receives a default pass-through')."""

    capability_id = 0
    name = "bridge"

    def __init__(self, spec: msg.MessageSpec):
        super().__init__()
        self.consumes = spec
        self.produces = spec

    def fn(self, params, x):
        return x

    def load(self) -> float:
        self._fn = lambda p, x: x
        self._loaded = True
        return 0.0

    def process(self, m: msg.Message) -> msg.Message:
        self.stats["processed"] += 1
        return m
