"""Model inputs and caches for the LM stack: stand-ins for tracing, and
concrete ones.

The port of the reference's ``launch/specs.py``.  ``input_specs(cfg,
shape)`` returns the step's arguments as stand-ins that hold no memory:

  train:    {"batch": {tokens, labels [, patches | frames]}}
  prefill:  {"batch": {tokens [, patches | frames]}}
  decode:   {"token", "pos", "cache"}

Where the reference gives ``ShapeDtypeStruct``s, these are tensors on the
``meta`` device (fake tensors where a ``FakeTensorMode`` is active); with
``mesh`` and ``rules`` given each is a DTensor of its rule's placements,
its local shard this rank's, so the mesh dry run traces the step on
them.  ``make_batch`` and ``init_cache`` make concrete ones for serving.
"""
from __future__ import annotations

import torch

from repro_torch.models import model as mdl
from repro_torch.sharding import RULE_SETS, logical_to_placements, spec_map

MODEL_DTYPE = torch.bfloat16
POS_EMPTY = 1 << 30     # an unwritten cache slot's position: always masked


def _contiguous_strides(shape):
    st, n = [], 1
    for d in reversed(shape):
        st.append(n)
        n *= d
    return tuple(reversed(st))


def struct(shape, dtype, axes, mesh=None, rules=None, device="meta"):
    """A stand-in of ``shape`` and ``dtype`` on ``device``; with ``mesh``
    and ``rules``, a DTensor of the placements ``axes`` map to, holding
    this rank's shard."""
    shape = tuple(shape)
    if mesh is None or rules is None:
        return torch.empty(shape, dtype=dtype, device=device)
    from torch.distributed.tensor import DTensor
    if isinstance(rules, str):
        rules = RULE_SETS[rules]
    pl = logical_to_placements(axes, rules, mesh, shape)
    local = list(shape)
    for i, p in enumerate(pl):
        if p.is_shard():
            local[p.dim] //= mesh.size(i)
    return DTensor.from_local(
        torch.empty(local, dtype=dtype, device=device), mesh, pl,
        run_check=False, shape=torch.Size(shape),
        stride=_contiguous_strides(shape))


def spec_structs(specs, mesh, rules, dtype, device="meta"):
    """A spec tree's stand-ins (``struct`` of each spec), a leaf without a
    dtype of its own in ``dtype``."""
    return spec_map(lambda s: struct(s.shape, s.dtype or dtype, s.axes,
                                     mesh, rules, device), specs)


def batch_specs(cfg, S: int, B: int, *, with_labels: bool, mesh=None,
                rules=None, device="meta"):
    b = {"tokens": struct((B, S), torch.int32, ("batch", "seq"), mesh, rules,
                          device)}
    if with_labels:
        b["labels"] = struct((B, S), torch.int32, ("batch", "seq"), mesh,
                             rules, device)
    if cfg.family == "vlm":
        b["patches"] = struct((B, cfg.n_patches, cfg.vit_dim), MODEL_DTYPE,
                              ("batch", "seq", None), mesh, rules, device)
    if cfg.family == "audio":
        b["frames"] = struct((B, cfg.encoder_len, cfg.d_model), MODEL_DTYPE,
                             ("batch", "frames", "embed"), mesh, rules,
                             device)
    return b


def param_structs(cfg, mesh=None, rules=None, dtype=MODEL_DTYPE,
                  device="meta"):
    """The parameter tree of ``mdl.param_specs`` as stand-ins (``LM(cfg,
    param_structs(...))`` is a model of them)."""
    return spec_structs(mdl.param_specs(cfg), mesh, rules, dtype, device)


def cache_structs(cfg, B: int, T: int, mesh=None, rules=None,
                  dtype=MODEL_DTYPE, device="meta"):
    return spec_structs(mdl.cache_specs(cfg, B, T), mesh, rules, dtype,
                        device)


def decode_specs(cfg, shape, mesh=None, rules=None, device="meta"):
    B, T = shape.global_batch, shape.seq_len
    return {
        "token": struct((B, 1), torch.int32, ("batch", "seq"), mesh, rules,
                        device),
        "pos": torch.empty((), dtype=torch.int32, device=device),
        "cache": cache_structs(cfg, B, T, mesh, rules, device=device),
    }


def input_specs(cfg, shape, mesh=None, rules=None, device="meta"):
    """Every model input for the step implied by ``shape.kind``."""
    if shape.kind == "train":
        return {"batch": batch_specs(cfg, shape.seq_len, shape.global_batch,
                                     with_labels=True, mesh=mesh, rules=rules,
                                     device=device)}
    if shape.kind == "prefill":
        return {"batch": batch_specs(cfg, shape.seq_len, shape.global_batch,
                                     with_labels=False, mesh=mesh,
                                     rules=rules, device=device)}
    if shape.kind == "decode":
        return decode_specs(cfg, shape, mesh, rules, device)
    raise ValueError(shape.kind)


# ---------------------------------------------------------------------------
# Concrete batches and caches
# ---------------------------------------------------------------------------
def make_batch(cfg, S: int, B: int, generator: torch.Generator,
               device=None, with_labels: bool = True):
    """Random prompt tokens, for the vlm and audio families the modality
    inputs (``patches`` (B, n_patches, vit_dim), ``frames`` (B,
    encoder_len, d_model), N(0, 1) in ``MODEL_DTYPE``), and, unless
    ``with_labels`` is False (serving), next-token ``labels`` (B, S) in
    [0, vocab), as the reference's batch holds; drawn from ``generator``
    (on ``device``) in that order, so the labels move none of serving's
    draws."""
    b = {"tokens": torch.randint(0, cfg.vocab_size, (B, S),
                                 generator=generator, dtype=torch.int32,
                                 device=device)}
    shape = {"vlm": (B, cfg.n_patches, cfg.vit_dim),
             "audio": (B, cfg.encoder_len, cfg.d_model)}.get(cfg.family)
    if shape is not None:
        name = "patches" if cfg.family == "vlm" else "frames"
        b[name] = torch.randn(shape, generator=generator, device=device,
                              dtype=torch.float32).to(MODEL_DTYPE)
    if with_labels:
        b["labels"] = torch.randint(0, cfg.vocab_size, (B, S),
                                    generator=generator, dtype=torch.int32,
                                    device=device)
    return b


def init_cache(cfg, B: int, T: int, *, dtype=MODEL_DTYPE, device=None):
    """Fresh (empty) cache, in ``mdl.cache_specs``'s tree (a list of
    blocks; for the MoE family a dict of ``scan`` and ``prefix``, for the
    audio family of ``dec`` and ``cross``).  Attention ``pos`` slots, of
    KV, ring and latent caches alike, hold ``POS_EMPTY`` so unwritten
    entries are masked out (cpos <= pos fails); the xLSTM stabilizers
    (fp32 leaves named ``m``) hold -1e30, as the reference's; floating
    leaves without a dtype of their own take ``dtype``."""
    def mk(tree, key=None):
        if isinstance(tree, dict):
            return {k: mk(v, k) for k, v in tree.items()}
        if isinstance(tree, list):
            return [mk(v, key) for v in tree]
        dt = tree.dtype or dtype
        if key == "pos":
            return torch.full(tree.shape, POS_EMPTY, dtype=dt, device=device)
        if key == "m" and dt == torch.float32:
            return torch.full(tree.shape, -1e30, dtype=dt, device=device)
        return torch.zeros(tree.shape, dtype=dt, device=device)

    return mk(mdl.cache_specs(cfg, B, T))
