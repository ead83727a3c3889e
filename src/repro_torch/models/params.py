"""Parameter specs, their initialisation, and the module that holds them.

The port of ``Spec`` and ``init_params`` from the reference's
``sharding.py``, without the mesh: a ``Spec`` is a shape, its logical axes
(kept so the specs read like the reference's), an init kind and an
optional dtype.  ``init_params`` walks a tree of dicts and lists of specs
and draws each leaf from one explicit ``torch.Generator`` on the target
device, so a full-width model is made on the card in seconds.  The numbers
differ from ``jax.random``'s; ``convert.lm_params`` carries the
reference's own weights across where they must be equal.

``Params`` turns such a tree of tensors into ``nn.Module``s that keep the
reference's names: ``p["wq"]`` reads the parameter ``wq``, ``p["blocks"]``
an ``nn.ModuleList``.  Its parameters are frozen, as serving wants them;
``trainable`` turns gradients on for training.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
from torch import nn

# init kind -> standard deviation of the normal draw
_SCALE = {"normal": 0.02, "small": 0.006}


@dataclass(frozen=True)
class Spec:
    shape: tuple
    axes: tuple  # logical axis names, len == len(shape)
    init: str = "normal"  # normal | zeros | ones | small
    dtype: Any = None  # default: model dtype

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def spec_map(fn, tree):
    """``fn`` applied to every ``Spec`` of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: spec_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [spec_map(fn, v) for v in tree]
    return fn(tree)


def init_params(tree, generator: torch.Generator, dtype, device=None):
    """Tensors for a tree of specs: zeros, ones, or N(0, 0.02^2) /
    N(0, 0.006^2) drawn in fp32 and cast, each in the spec's dtype or
    ``dtype`` (so an int8 or fp32 leaf keeps its type in a bf16 tree; an
    int8 "normal" leaf casts to all zeros, as the reference's does).
    Leaves are drawn in the tree's order from ``generator``, which must
    live on ``device``."""
    def one(s: Spec):
        dt = s.dtype or dtype
        if s.init == "zeros":
            return torch.zeros(s.shape, dtype=dt, device=device)
        if s.init == "ones":
            return torch.ones(s.shape, dtype=dt, device=device)
        x = torch.randn(s.shape, generator=generator, dtype=torch.float32,
                        device=device)
        return x.mul_(_SCALE[s.init]).to(dt)

    return spec_map(one, tree)


class Params(nn.Module):
    """One node of a parameter tree: tensors become (frozen) parameters,
    dicts ``Params`` and lists ``nn.ModuleList``s, all under the
    reference's names; ``p[name]``, ``name in p`` and ``p.get`` read them
    as the reference reads its dicts."""

    def __init__(self, tree: dict):
        super().__init__()
        for name, v in tree.items():
            if isinstance(v, torch.Tensor):
                self.register_parameter(
                    name, nn.Parameter(v, requires_grad=False))
            elif isinstance(v, list):
                self.add_module(name, nn.ModuleList(Params(x) for x in v))
            else:
                self.add_module(name, Params(v))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules

    def get(self, name: str, default=None):
        return self[name] if name in self else default


def trainable(module: nn.Module) -> nn.Module:
    """``module`` with ``requires_grad`` on for every floating-point
    parameter; int8 leaves (int8 experts) stay frozen."""
    for p in module.parameters():
        if p.dtype.is_floating_point:
            p.requires_grad_()
    return module
