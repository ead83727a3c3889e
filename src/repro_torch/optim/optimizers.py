"""Optimizers as (init, update) pairs over named parameters.

The port of the reference's ``optim/optimizers.py`` (no optax, no torch.optim):

  adamw        fp32 m/v                         (< ~30 B params)
  adamw8       blockwise-int8 m/v               (mid-size, 4x state cut)
  adafactor    factored second moment, no mom.  (200 B+ giants)

``params`` is a dict of tensors by name, or an ``nn.Module`` (its
parameters that require grad, by their dotted names); ``grads`` is a dict
with the same names.  The state mirrors the parameters: a dict by name
under ``"m"`` / ``"v"`` (adamw) or ``"f"`` (adafactor).

``update(grads, state, params, step)`` returns ``(params, state, metrics)``
as the reference's does, but updates the parameters and the fp32 state in
place, under ``torch.no_grad()``, one leaf at a time: the fp32 working set
is a few temporaries of one leaf (the reference bounds it per layer slice
with ``_layer_mapped``; the port holds one module per block, so a leaf is
already one layer).  The arithmetic is the reference's, in its order.

Differences by design: adafactor factors a leaf by the port's own leaf
shape.  The reference's layer-stacked leaves are one dimension higher
(a layer norm's (L, d) stack is factored there, a (d,) leaf here keeps a
full second moment); adamw's elementwise math is the same either way.

Under a mesh the parameters, gradients and state are DTensors of the same
placements (``state_specs``: the state shards like its parameter); the
global norm's sum of squares is reduced over every shard before the clip,
and adafactor's row and column means over a split dim are reduced by
DTensor, so the update is the unsharded one.  int8 (``adamw8``) state is
quantized in blocks of the whole leaf: a DTensor leaf is gathered for it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch
from torch import nn

from repro_torch.optim.quant import QTensor, dequantize, quantize, zeros_like_q


@dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any, Any], tuple]  # (g, st, p, step)


def named_leaves(params) -> dict:
    """{name: tensor} of ``params``: a dict as it is, a module's
    parameters that require grad."""
    if isinstance(params, nn.Module):
        return {n: p for n, p in params.named_parameters()
                if p.requires_grad}
    return dict(params)


def _replicated(x):
    """A 0-d DTensor (a partial sum of shards) reduced and made plain;
    anything else as it is."""
    from repro_torch.sharding import full_tensor
    return full_tensor(x)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf of a dict, in fp32; a
    DTensor leaf's sum is reduced over all its shards first."""
    leaves = [_replicated(torch.sum(torch.square(x.float())))
              for x in tree.values()]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def _clip_scale(n, max_norm):
    return torch.clamp(max_norm / torch.clamp(n, min=1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm``, the norm)."""
    n = global_norm(grads)
    scale = _clip_scale(n, max_norm)
    return {k: (g.float() * scale).to(g.dtype) for k, g in grads.items()}, n


def _grad_norm_and_scale(grads, clip):
    gn = global_norm(grads)
    return gn, (_clip_scale(gn, clip) if clip else None)


def _scaled(g, scale):
    """A leaf's gradient after clipping, in fp32 (a new tensor)."""
    if scale is None:
        return g.float().clone()
    return (g.float() * scale).to(g.dtype).float()


def _full(x):
    """x whole: a DTensor gathered, else x."""
    from repro_torch.sharding import full_tensor
    return full_tensor(x)


def _assign(p, value):
    """p = value in place; a whole ``value`` into a DTensor ``p`` is cut
    to p's shard."""
    from repro_torch.sharding import is_dtensor
    if is_dtensor(p) and not is_dtensor(value):
        from torch.distributed.tensor import distribute_tensor
        value = distribute_tensor(value, p.device_mesh, p.placements)
    p.copy_(value)


def _zeros_dropping(p, drop: int, shape):
    """fp32 zeros of ``shape``: p's shape without dim ``drop``; for a
    DTensor p, a DTensor with p's placements on the dims that remain."""
    from repro_torch.sharding import is_dtensor
    if not is_dtensor(p):
        return torch.zeros(shape, dtype=torch.float32, device=p.device)
    from torch.distributed.tensor import Replicate, Shard, zeros
    drop %= p.dim()
    pl = [Replicate() if (q.is_shard() and q.dim == drop) else
          Shard(q.dim - (q.dim > drop)) if q.is_shard() else q
          for q in p.placements]
    return zeros(shape, dtype=torch.float32, device_mesh=p.device_mesh,
                 placements=pl)


def _f32(v) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32)


# ---------------------------------------------------------------------------
# AdamW (fp32 or blockwise-int8 state)
# ---------------------------------------------------------------------------
def adamw(lr: Callable, *, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
          clip=1.0, int8_state=False) -> Optimizer:
    def init(params):
        leaves = named_leaves(params)
        def z(p):
            if int8_state:
                return zeros_like_q(_full(p))
            # a DTensor parameter's state is a DTensor of its placements
            return torch.zeros_like(p, dtype=torch.float32,
                                    memory_format=torch.contiguous_format)
        return {"m": {k: z(p) for k, p in leaves.items()},
                "v": {k: z(p) for k, p in leaves.items()}}

    def update(grads, state, params, step):
        leaves = named_leaves(params)
        with torch.no_grad():
            gn, scale = _grad_norm_and_scale(grads, clip)
            t = _f32(int(step)) + 1.0
            c1 = float(1.0 - torch.pow(_f32(b1), t))
            c2 = float(1.0 - torch.pow(_f32(b2), t))
            lr_t = lr(step)
            lr_f = float(lr_t)
            for name, p in leaves.items():
                g = _scaled(grads[name], scale)
                m, v = state["m"][name], state["v"][name]
                quant = isinstance(m, QTensor)
                mf = dequantize(m) if quant else m
                vf = dequantize(v) if quant else v
                # int8 blocks span the whole leaf: a DTensor's is gathered
                g = _full(g) if quant else g
                mf.mul_(b1).add_(g * (1 - b1))
                vf.mul_(b2).add_((g * (1 - b2)).mul_(g))
                del g
                upd = (mf / c1).div_(torch.sqrt(vf / c2).add_(eps))
                pf = _full(p).float() if quant else p.float()
                upd.add_(weight_decay * pf)
                _assign(p, pf - upd.mul_(lr_f))   # cast to p's dtype
                del upd, pf
                if quant:
                    state["m"][name], state["v"][name] = quantize(mf), \
                        quantize(vf)
        return params, state, {"grad_norm": gn, "lr": lr_t}

    return Optimizer("adamw8" if int8_state else "adamw", init, update)


# ---------------------------------------------------------------------------
# Adafactor (factored 2nd moment, momentum-free) — giants' memory tier
# ---------------------------------------------------------------------------
def adafactor(lr: Callable, *, decay=0.99, eps=1e-30, clip=1.0,
              weight_decay=0.0) -> Optimizer:
    """Factored AdamW-style update. 2-D+ leaves keep row/col second-moment
    factors (O(n+m) memory); 0/1-D leaves keep a full fp32 second moment."""

    def init(params):
        def z(p):
            if p.dim() >= 2:
                return {"r": _zeros_dropping(p, -1, p.shape[:-1]),  # rows
                        "c": _zeros_dropping(p, -2,
                                             p.shape[:-2] + p.shape[-1:])}
            return {"v": torch.zeros_like(
                p, dtype=torch.float32, memory_format=torch.contiguous_format)}
        return {"f": {k: z(p) for k, p in named_leaves(params).items()}}

    def update(grads, state, params, step):
        leaves = named_leaves(params)
        with torch.no_grad():
            gn, scale = _grad_norm_and_scale(grads, clip)
            lr_t = lr(step)
            lr_f = float(lr_t)
            t = _f32(int(step)) + 1.0
            beta_t = torch.minimum(1.0 - t ** -0.8, _f32(decay))
            beta, one_minus = float(beta_t), float(1.0 - beta_t)
            for name, p in leaves.items():
                g = _scaled(grads[name], scale)
                f = state["f"][name]
                g2 = (g * g).add_(eps)
                if p.dim() >= 2:
                    r = f["r"].mul_(beta).add_(one_minus * g2.mean(dim=-1))
                    c = f["c"].mul_(beta).add_(one_minus * g2.mean(dim=-2))
                    rc = r / torch.clamp(r.mean(dim=-1, keepdim=True),
                                         min=1e-30)
                    vhat = rc[..., None] * c[..., None, :]
                else:
                    vhat = f["v"].mul_(beta).add_(one_minus * g2)
                del g2
                upd = g.div_(torch.sqrt(vhat + 1e-30))
                del vhat
                # update clipping (Adafactor RMS trick)
                rms = torch.sqrt(torch.mean(torch.square(upd)) + 1e-30)
                upd.div_(torch.clamp(rms, min=1.0))
                pf = p.float()
                upd.add_(weight_decay * pf)
                p.copy_(pf - upd.mul_(lr_f))   # cast to p's dtype
                del upd, pf
        return params, state, {"grad_norm": gn, "lr": lr_t}

    return Optimizer("adafactor", init, update)


def state_specs(opt: Optimizer, param_specs):
    """Spec tree of the optimizer state, keyed as the state is: by each
    trainable leaf's dotted name (``blocks.0.attn.wq``).  State leaves
    shard exactly like their parameter (ZeRO): the same logical axes,
    reduced for adafactor's factored moments.  int8 leaves (int8 experts)
    take no gradient and have no state."""
    from repro_torch.models.params import Spec
    from repro_torch.sharding import spec_leaves

    leaves = {k: s for k, s in spec_leaves(param_specs).items()
              if s.dtype is None or s.dtype.is_floating_point}
    if opt.name in ("adamw", "adamw8"):
        f32 = {k: Spec(s.shape, s.axes, "zeros", torch.float32)
               for k, s in leaves.items()}
        return {"m": f32, "v": dict(f32)}
    if opt.name == "adafactor":
        def fact(s):
            if len(s.shape) >= 2:
                return {
                    "r": Spec(s.shape[:-1], s.axes[:-1], "zeros",
                              torch.float32),
                    "c": Spec(s.shape[:-2] + s.shape[-1:],
                              s.axes[:-2] + s.axes[-1:], "zeros",
                              torch.float32),
                }
            return {"v": Spec(s.shape, s.axes, "zeros", torch.float32)}
        return {"f": {k: fact(s) for k, s in leaves.items()}}
    raise ValueError(opt.name)


def for_config(cfg, lr_fn=None) -> Optimizer:
    """Memory-tier policy: giants get adafactor, the rest AdamW."""
    from repro_torch.optim.schedules import cosine_warmup
    lr_fn = lr_fn or cosine_warmup(3e-4, warmup=100, total=10_000)
    n = param_count(cfg)
    if n >= 100e9:
        return adafactor(lr_fn)
    return adamw(lr_fn)


def param_count(cfg) -> float:
    """Closed-form parameter count from an ArchConfig (approximate, for
    policy decisions and MODEL_FLOPS)."""
    d, L, V = cfg.d_model, cfg.n_layers, cfg.vocab_size
    emb = V * d * (1 if cfg.tie_embeddings else 2)
    if cfg.family == "moe":
        attn = L * _mla_params(cfg)
        dense_ff = cfg.first_dense_layers * 3 * d * cfg.d_ff
        moe_layers = L - cfg.first_dense_layers
        per_exp = 3 * d * cfg.moe_d_ff
        routed = moe_layers * cfg.n_experts * per_exp
        shared = moe_layers * cfg.n_shared_experts * per_exp
        router = moe_layers * d * cfg.n_experts
        return emb + attn + dense_ff + routed + shared + router
    if cfg.family == "hybrid":
        # mamba blocks + one shared attn/mlp block (weight-tied)
        din = cfg.ssm_expand * d
        per_mamba = d * (2 * din + 2 * cfg.ssm_state) + din * d + din
        n_attn = 1
        attn = n_attn * (4 * d * d + 3 * d * cfg.d_ff)
        return emb + L * per_mamba + attn
    if cfg.family == "ssm":
        din = 2 * d
        per = d * din * 4 + din * d  # qkv/gates + out
        return emb + L * per
    dh = cfg.dh
    attn_p = d * (cfg.n_heads * dh) * 2 + d * (cfg.n_kv_heads * dh) * 2
    ff_mult = 3 if cfg.mlp_gated else 2
    ff = ff_mult * d * cfg.d_ff
    enc = 0
    if cfg.family == "audio":
        enc = cfg.encoder_layers * (attn_p + ff)
    return emb + L * (attn_p + ff) + enc


def _mla_params(cfg):
    d, H = cfg.d_model, cfg.n_heads
    qn, qr, vd = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    q = (d * cfg.q_lora_rank + cfg.q_lora_rank * H * (qn + qr)
         if cfg.q_lora_rank else d * H * (qn + qr))
    kv = d * (cfg.kv_lora_rank + qr) + cfg.kv_lora_rank * H * (qn + vd)
    o = H * vd * d
    return q + kv + o
