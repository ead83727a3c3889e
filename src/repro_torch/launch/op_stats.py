"""Op statistics of a traced step: the dry run's "profiler".

The counterpart of the reference's ``launch/hlo_stats.py``.  There is no
HLO in PyTorch: the step runs eagerly on meta tensors (``launch/dryrun.py``)
and ``OpStats``, a ``TorchDispatchMode``, watches each operator as it runs
on a rank's local shards.  It sits below DTensor: it declines every call
on DTensors (``NotImplemented``), so DTensor lowers the call to its local
operators and collectives, which the mode then sees; the operators
DTensor runs on fake tensors to propagate shapes are skipped.  So every
number is per device, as the reference's SPMD per-device program gives
them, and nothing is counted at a DTensor's global shape (which
``FlopCounterMode``, sitting above DTensor, would do).

It counts the same three inputs of the roofline as the reference's:

  * dot flops: ``mm`` / ``bmm`` / ``addmm`` / ``baddbmm`` by their
    formulas, and the kernels' operators (``repro_torch::flash_attention``,
    ``repro_torch::mamba2_ssd`` and their backwards) by the formulas they
    register with ``torch.utils.flop_counter``;
  * matmul-boundary bytes: the operand and result bytes of those calls;
  * collective bytes, by type and by mesh axis: the input bytes of each
    ``_c10d_functional`` collective, its axis read from its group.

A sequential scan traced on meta tensors runs one step for all of them
(``kernels.trace.repeated``: xLSTM's sLSTM), and each of its operators
counts as many times as the scan has steps, as the reference's HLO
statistics multiply a loop body by its trip count.

``calls`` counts every operator seen, and ``largest`` keeps the biggest
new storages its results allocate (``launch/memdebug.py`` lists them).
``live`` and ``peak`` follow the bytes of the storages alive on the rank: those ``track`` is given (the
parameters, optimizer state and inputs) and every result, each until its
storage is freed (a weak reference tells).  ``MemTracker`` of
``torch.distributed._tools`` does the same, but its module hooks need
gradients, which serving steps do not record.
"""
from __future__ import annotations

import heapq
import weakref
from collections import Counter, defaultdict
from dataclasses import dataclass, field

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.kernels import trace

_COLLECTIVES = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "broadcast", "broadcast_": "broadcast",
}
_KERNEL_OPS = ("flash_attention", "flash_attention_backward", "mamba2_ssd",
               "mamba2_ssd_backward")


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _is_shape_prop(args, out) -> bool:
    """Whether a call takes or makes fake tensors: DTensor's shape
    propagation."""
    from torch._subclasses.fake_tensor import FakeTensor
    return any(isinstance(a, FakeTensor)
               for a in tree_flatten((args, out))[0])


@dataclass
class OpStats:
    dot_flops: float = 0.0
    dot_bytes: float = 0.0
    collective_bytes: float = 0.0
    collective_by_type: dict = field(default_factory=dict)
    collective_by_axis: dict = field(default_factory=dict)
    collective_count: int = 0
    calls: dict = field(default_factory=dict)
    kernel_calls: dict = field(default_factory=dict)
    largest: list = field(default_factory=list)

    def scaled(self, n: float) -> "OpStats":
        """The counts of ``n`` such runs (one microbatch traced, n run)."""
        return OpStats(
            dot_flops=self.dot_flops * n, dot_bytes=self.dot_bytes * n,
            collective_bytes=self.collective_bytes * n,
            collective_by_type={k: v * n for k, v in
                                self.collective_by_type.items()},
            collective_by_axis={k: v * n for k, v in
                                self.collective_by_axis.items()},
            collective_count=int(self.collective_count * n),
            calls={k: int(v * n) for k, v in self.calls.items()},
            kernel_calls={k: int(v * n) for k, v in
                          self.kernel_calls.items()},
            largest=list(self.largest))

    def copy(self) -> "OpStats":
        return self.scaled(1)

    def to_dict(self, top: int = 0) -> dict:
        d = {k: v for k, v in self.__dict__.items()
             if k not in ("calls", "largest")}
        if top:
            d["largest"] = [
                {"bytes": b, "op": op, "shape": list(shape), "dtype": dt}
                for b, op, shape, dt in sorted(self.largest,
                                               reverse=True)[:top]]
        return d


class OpCounter(TorchDispatchMode):
    """Counts ``OpStats`` of the local operators run inside it.  ``mesh``
    names the collectives' axes (a group that is no single mesh dim counts
    as ``"other"``); ``keep`` is how many of the largest results to
    keep."""

    def __init__(self, mesh=None, keep: int = 64):
        super().__init__()
        self.stats = OpStats()
        self.keep = keep
        self._calls = Counter()
        self._axis_of = {}
        if mesh is not None:
            for i, name in enumerate(mesh.mesh_dim_names):
                self._axis_of[mesh.get_group(i).group_name] = name
        self._by_type = defaultdict(float)
        self._by_axis = defaultdict(float)
        self.live = 0
        self.peak = 0
        self._storages = {}

    def track(self, *tensors):
        """Count these tensors' storages as alive (a DTensor's local
        shard)."""
        for t in tensors:
            self._hold(t.to_local() if isinstance(t, DTensor) else t)

    def _hold(self, t) -> int:
        """Count t's storage as alive; its bytes if it is new, else 0."""
        st = t.untyped_storage()
        key = st._cdata
        if key in self._storages:
            return 0
        nb = st.nbytes()

        def freed(_ref, key=key, nb=nb):
            if self._storages.pop(key, None) is not None:
                self.live -= nb

        self._storages[key] = weakref.ref(st, freed)
        self.live += nb
        self.peak = max(self.peak, self.live)
        return nb

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if _is_shape_prop(args, out):
            return out
        self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out):
        from torch.utils.flop_counter import flop_registry
        pkt = func._overloadpacket
        ns, name = pkt._qualified_op_name.split("::")
        rep = trace.times()        # a scan's step traced for all its steps
        self._calls[f"{ns}::{name}"] += rep
        tensors = [a for a in tree_flatten((args, kwargs))[0]
                   if isinstance(a, torch.Tensor)]
        outs = [o for o in tree_flatten(out)[0] if isinstance(o, torch.Tensor)]
        if ns == "_c10d_functional" and name in _COLLECTIVES:
            kind = _COLLECTIVES[name]
            nb = sum(_nbytes(t) for t in tensors)
            group = next((a for a in tree_flatten(args)[0]
                          if isinstance(a, str) and a in self._axis_of), None)
            axis = self._axis_of.get(group, "other")
            self._by_type[kind] += nb * rep
            self._by_axis[axis] += nb * rep
            self.stats.collective_bytes += nb * rep
            self.stats.collective_count += rep
        elif pkt in flop_registry and (ns == "aten" or name in _KERNEL_OPS):
            self.stats.dot_flops += rep * flop_registry[pkt](
                *args, **kwargs, out_val=out)
            self.stats.dot_bytes += rep * (sum(_nbytes(t) for t in tensors)
                                           + sum(_nbytes(o) for o in outs))
            if ns == "repro_torch":
                self.stats.kernel_calls[name] = \
                    self.stats.kernel_calls.get(name, 0) + rep
        for o in outs:
            nb = self._hold(o)
            if not nb:            # a view, or a tensor already alive
                continue
            item = (nb, f"{ns}::{name}", tuple(o.shape),
                    str(o.dtype).split(".")[-1])
            if len(self.stats.largest) < self.keep:
                heapq.heappush(self.stats.largest, item)
            elif item > self.stats.largest[0]:
                heapq.heapreplace(self.stats.largest, item)

    def result(self) -> OpStats:
        """The counts so far (a snapshot)."""
        self.stats.collective_by_type = dict(self._by_type)
        self.stats.collective_by_axis = dict(self._by_axis)
        self.stats.calls = dict(self._calls)
        return self.stats.copy()
