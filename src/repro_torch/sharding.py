"""Logical-axis sharding: rules map logical tensor axes -> mesh axes.

The port of the reference's ``sharding.py`` onto ``torch.distributed``'s
``DeviceMesh`` and DTensor.  Model code names each tensor's axes
("embed", "heads", ...); a rule set picks the mesh axes, so the same model
runs under tensor-parallel (TP), fully-sharded (FSDP) or single-device
rules.  In torch terms:

  * a logical-axis rule becomes a tuple of DTensor placements, one a mesh
    dim (``logical_to_placements``); its ``pspec`` form (a mesh-axis name,
    a tuple of names, or None a tensor dim) is the reference's
    ``PartitionSpec`` written out, and follows the same three rules: mesh
    axes the mesh lacks are dropped, a mesh axis is used once a tensor,
    and a sharding that does not divide the dim is dropped;
  * ``with_sharding_constraint`` becomes ``DTensor.redistribute``
    (``shard``), a no-op outside ``use_rules`` or on a plain tensor;
  * ``shardings`` + ``device_put`` becomes ``distribute_params``, which
    replaces each parameter of the port's ``Params`` modules with a DTensor
    of its rule's placements.

A logical axis mapped to two mesh axes, ``("pod", "data")``, shards one
tensor dim over both, pod-major, as ``P(("pod", "data"))`` does: DTensor
splits a dim by its mesh dims in mesh order.

``Spec``, ``spec_map`` and ``init_params`` live in ``models/params.py`` and
are re-exported here, as the reference keeps them in this module.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Mapping, Sequence

import torch
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)

from repro_torch.models.params import Spec, init_params, spec_map  # noqa: F401

# ---------------------------------------------------------------------------
# Logical axis vocabulary
# ---------------------------------------------------------------------------
#   layers     scan dimension over (super)blocks       -> never sharded
#   batch      global batch                            -> (pod, data)
#   seq        sequence (activations)                  -> None (or "data" SP)
#   cache_seq  KV-cache time axis                      -> None / "data"
#   embed      d_model                                 -> None (TP) / fsdp
#   vocab      vocabulary                              -> model
#   heads      query heads                             -> model
#   kv_heads   kv heads                                -> model (capped)
#   head_dim   per-head dim                            -> None
#   mlp        ffn hidden                              -> model
#   experts    MoE experts                             -> model (EP)
#   expert_mlp per-expert ffn hidden                   -> None
#   q_lora / kv_lora   MLA latents                     -> None
#   conv, state, ssm_heads, inner  SSM internals       -> model where safe

Rules = Mapping[str, Any]

TP_RULES: Rules = {
    "batch": ("pod", "data"),
    "seq": None,
    "act_seq": None,   # residual-stream seq axis at superblock boundaries
    "cache_seq": None,
    "cache_batch": ("pod", "data"),
    "embed": None,
    "embed_table": None,
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "mlp": "model",
    "experts": "model",
    "expert_mlp": None,
    "q_lora": None,
    "kv_lora": None,
    "conv": None,
    "state": None,
    "ssm_heads": "model",
    "inner": "model",
    "layers": None,
    "frames": None,
}

# FSDP: weights additionally sharded along their "embed"/"expert_mlp" axis over
# the data axis (ZeRO-3); XLA inserts per-layer all-gathers inside the scan.
FSDP_RULES: Rules = dict(
    TP_RULES,
    embed="data",
    expert_mlp="data",
    q_lora="data",
    kv_lora="data",
    head_dim=None,
)

# Long-context serving: shard the KV-cache time axis over "data" (sequence
# parallelism over the cache) because batch=1 cannot use the data axis.
LONG_CONTEXT_RULES: Rules = dict(
    TP_RULES,
    cache_seq="data",
    cache_batch=None,
    batch=None,
)

# Decode serving (32k context): the KV-cache time axis shards over "model"
# (flash-decode style: each model shard scores its cache chunk; softmax
# stats + context psum are tiny) so 128 concurrent 32k caches fit HBM.
DECODE_RULES: Rules = dict(
    TP_RULES,
    cache_seq="model",
)

# MoE decode serving: additionally spread routed experts over ("pod","data")
# (EP) with the per-expert ffn hidden dim over "model" (intra-expert TP).
# Token batch stays on ("pod","data") too; moe_fwd gathers tokens across EP
# shards and reduce-scatters outputs back (the TPU analogue of the GPU
# all-to-all).
DECODE_MOE_RULES: Rules = dict(
    DECODE_RULES,
    experts=("pod", "data"),
    expert_mlp="model",
)

# Sequence-parallel training: the residual stream (and therefore the
# scan-over-layers carry that dominates activation memory) shards its seq
# axis over "model" between superblocks; blocks gather what they need
# (Megatron-SP adapted to scan + logical axes). Attention/MoE internals
# keep their existing annotations ("seq" -> None), so XLA inserts the
# boundary gathers automatically.
FSDP_SP_RULES: Rules = dict(FSDP_RULES, act_seq="model")

RULE_SETS = {
    "tp": TP_RULES,
    "fsdp": FSDP_RULES,
    "fsdp_sp": FSDP_SP_RULES,
    "long": LONG_CONTEXT_RULES,
    "decode": DECODE_RULES,
    "decode_moe": DECODE_MOE_RULES,
}

_state = threading.local()
_implicit_depth = 0                 # mesh contexts open, in every thread
_implicit_lock = threading.Lock()


def _current_rules() -> Rules | None:
    return getattr(_state, "rules", None)


def _current_mesh():
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def use_rules(rules: Rules | str, mesh=None):
    """Activate a rule set (and the ``DeviceMesh`` it maps onto) for model
    code run inside this context."""
    if isinstance(rules, str):
        rules = RULE_SETS[rules]
    global _implicit_depth
    prev = (_current_rules(), _current_mesh())
    _state.rules, _state.mesh = rules, mesh
    # plain tensors made inside (positions, masks) meet DTensors as
    # replicated ones.  torch's ``implicit_replication`` sets one flag for
    # the process and clears it on exit, so only the outermost mesh
    # context (of any thread: remat's recompute re-enters on autograd's)
    # enters it
    ctx = contextlib.nullcontext()
    with _implicit_lock:
        if mesh is not None and _implicit_depth == 0:
            from torch.distributed.tensor.experimental import \
                implicit_replication
            ctx = implicit_replication()
        _implicit_depth += mesh is not None
    try:
        with ctx:
            yield
    finally:
        with _implicit_lock:
            _implicit_depth -= mesh is not None
        _state.rules, _state.mesh = prev


def current_mesh_and_rules():
    return _current_mesh(), _current_rules()


def under_current_rules(fn):
    """``fn`` made to run under the rules active now, wherever it is
    called: remat's recompute runs on autograd's device thread, which does
    not see this thread's rules."""
    mesh, rules = current_mesh_and_rules()
    if rules is None:
        return fn

    def run(*args, **kwargs):
        with use_rules(rules, mesh):
            return fn(*args, **kwargs)
    return run


def active():
    """(mesh, rules) where both are set, else None."""
    mesh, rules = current_mesh_and_rules()
    return (mesh, rules) if mesh is not None and rules is not None else None


def axis_names(mesh) -> tuple:
    """The mesh's axis names: ``mesh_dim_names`` of a ``DeviceMesh``, or
    ``axis_names`` of anything shaped like the reference's meshes."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def _axis_sizes(mesh) -> dict:
    """{axis name: size} of the mesh."""
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    return dict(mesh.shape)


def mesh_axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    sizes = _axis_sizes(mesh)
    if isinstance(axis, (tuple, list)):
        n = 1
        for a in axis:
            n *= sizes[a]
        return n
    return sizes[axis]


def logical_to_pspec(axes: Sequence[str | None], rules: Rules, mesh=None,
                     shape: Sequence[int] | None = None) -> tuple:
    """Logical axes -> the reference's PartitionSpec as a tuple: a mesh
    axis name, a tuple of them, or None a tensor dim, trailing Nones cut.
    Drops mesh axes that do not exist in ``mesh`` and shardings that do
    not divide ``shape`` evenly."""
    parts = []
    used: set = set()
    names = set(axis_names(mesh)) if mesh is not None else None
    sizes = _axis_sizes(mesh) if mesh is not None else None
    for i, ax in enumerate(axes):
        m = rules.get(ax) if ax is not None else None
        flat = [a for a in (m if isinstance(m, (tuple, list)) else (m,))
                if a is not None]
        if names is not None:
            flat = [a for a in flat if a in names]
        # never map two logical axes onto the same mesh axis in one pspec
        flat = [a for a in flat if a not in used]
        if flat and shape is not None and mesh is not None:
            sz = 1
            for a in flat:
                sz *= sizes[a]
            if shape[i] % sz != 0:
                flat = []
        if not flat:
            parts.append(None)
        else:
            used.update(flat)
            parts.append(tuple(flat) if len(flat) > 1 else flat[0])
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def pspec_to_placements(pspec: Sequence, mesh) -> tuple:
    """A pspec tuple -> one placement a mesh dim: ``Shard(i)`` on each mesh
    dim that tensor dim i is split over, ``Replicate()`` on the rest."""
    names = axis_names(mesh)
    out = [Replicate()] * len(names)
    for i, part in enumerate(pspec):
        if part is None:
            continue
        for a in (part if isinstance(part, tuple) else (part,)):
            out[names.index(a)] = Shard(i)
    return tuple(out)


def logical_to_placements(axes: Sequence[str | None], rules: Rules, mesh,
                          shape: Sequence[int] | None = None) -> tuple:
    """Logical axes -> DTensor placements on ``mesh``, one a mesh dim; the
    counterpart of ``logical_to_pspec`` under the same rules."""
    if isinstance(rules, str):
        rules = RULE_SETS[rules]
    return pspec_to_placements(logical_to_pspec(axes, rules, mesh, shape),
                               mesh)


def is_dtensor(x) -> bool:
    return isinstance(x, DTensor)


def shard(x, *axes: str | None):
    """Constrain an activation's sharding by logical axes: redistribute a
    DTensor to its rule's placements.  The identity without active rules
    or on a plain tensor."""
    act = active()
    if act is None or not is_dtensor(x):
        return x
    mesh, rules = act
    pl = logical_to_placements(axes, rules, mesh, tuple(x.shape))
    if tuple(x.placements) == pl:
        return x
    return x.redistribute(mesh, pl)


def placements_of(x, axes):
    """The placements ``axes`` give a tensor of x's shape under the active
    rules."""
    mesh, rules = active()
    return logical_to_placements(axes, rules, mesh, tuple(x.shape))


def to_dtensor(x: torch.Tensor, axes, mesh, rules):
    """A full tensor (the same on every rank) as a DTensor of its rule's
    placements."""
    return distribute_tensor(x, mesh, logical_to_placements(
        axes, rules, mesh, tuple(x.shape)))


def spec_leaves(tree, prefix: str = "") -> dict:
    """{dotted name: Spec} of a spec tree, names as the port's modules give
    their parameters (``blocks.0.attn.wq``)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(spec_leaves(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def distribute_params(params: torch.nn.Module, specs, mesh, rules):
    """Replace every parameter of ``params`` (the port's ``LM`` or any
    ``Params`` tree) by a DTensor of its spec's placements on ``mesh``; the
    counterpart of ``shardings`` + ``device_put``.  ``specs`` is the spec
    tree the parameters were made from (``model.param_specs(cfg)``).  A
    parameter keeps its ``requires_grad``.  Returns ``params``."""
    if isinstance(rules, str):
        rules = RULE_SETS[rules]
    by_name = spec_leaves(specs)
    for mod_name, mod in list(params.named_modules()):
        for pname, p in list(mod._parameters.items()):
            if p is None or is_dtensor(p):
                continue
            full = f"{mod_name}.{pname}" if mod_name else pname
            s = by_name[full]
            pl = logical_to_placements(s.axes, rules, mesh, s.shape)
            d = distribute_tensor(p.detach(), mesh, pl)
            mod._parameters[pname] = torch.nn.Parameter(
                d, requires_grad=p.requires_grad)
    return params


def full_tensor(x):
    """x gathered whole where it is a DTensor, else x."""
    return x.full_tensor() if is_dtensor(x) else x


def gather(w):
    """A weight as it is used: replicated over every mesh axis but
    ``model`` (its tensor-parallel split stays), the all-gather ZeRO-3
    makes before each use of an FSDP-sharded weight.  The identity on a
    plain tensor or one already so placed."""
    if not is_dtensor(w):
        return w
    names = axis_names(w.device_mesh)
    pl = tuple(p if n == "model" else Replicate()
               for n, p in zip(names, w.placements))
    if pl == tuple(w.placements):
        return w
    return w.redistribute(w.device_mesh, pl)


def distribute_tree(tree, specs, mesh, rules):
    """A tree of full tensors (a cache, a batch) as DTensors of the
    placements of the spec tree ``specs`` beside it (dicts and lists)."""
    if isinstance(rules, str):
        rules = RULE_SETS[rules]
    if isinstance(tree, dict):
        return {k: distribute_tree(v, specs[k], mesh, rules)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [distribute_tree(v, s, mesh, rules)
                for v, s in zip(tree, specs)]
    return to_dtensor(tree, specs.axes, mesh, rules)


def full_tree(tree):
    """A tree with each DTensor gathered whole."""
    if isinstance(tree, dict):
        return {k: full_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(full_tree(v) for v in tree)
    return full_tensor(tree)


def shardings(tree, mesh, rules):
    """The placements of every spec of a spec tree on ``mesh``: the
    counterpart of the reference's ``shardings``."""
    if isinstance(rules, str):
        rules = RULE_SETS[rules]
    return spec_map(lambda s: logical_to_placements(s.axes, rules, mesh,
                                                    s.shape), tree)


def placements_to_pspec(placements, mesh, ndim: int) -> tuple:
    """DTensor placements -> the pspec tuple (``logical_to_pspec``'s form):
    for each tensor dim the mesh axes that split it, in mesh order."""
    names = axis_names(mesh)
    parts = [[] for _ in range(ndim)]
    for i, p in enumerate(placements):
        if p.is_shard():
            parts[p.dim].append(names[i])
    out = [None if not a else (a[0] if len(a) == 1 else tuple(a))
           for a in parts]
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def split_heads(y, n: int, dh: int):
    """y (..., n * dh) viewed as (..., n, dh).  A DTensor split along its
    last dim over mesh dims that do not divide ``n`` is gathered on those
    first (a head cannot straddle ranks)."""
    if is_dtensor(y):
        last = y.dim() - 1
        mesh = y.device_mesh
        pl = tuple(Replicate() if p.is_shard() and p.dim == last and
                   n % mesh.size(i) else p
                   for i, p in enumerate(y.placements))
        if pl != tuple(y.placements):
            y = y.redistribute(mesh, pl)
    return y.reshape(*y.shape[:-1], n, dh)
