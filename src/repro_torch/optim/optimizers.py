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
``state_specs`` feeds the reference's dry-run and ports with the mesh
tooling (ROADMAP Queue 1 item 11).
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


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf of a dict, in fp32."""
    leaves = [torch.sum(torch.square(x.float())) for x in tree.values()]
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
                return zeros_like_q(p)
            return torch.zeros(p.shape, dtype=torch.float32,
                               device=p.device)
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
                mf.mul_(b1).add_(g * (1 - b1))
                vf.mul_(b2).add_((g * (1 - b2)).mul_(g))
                del g
                upd = (mf / c1).div_(torch.sqrt(vf / c2).add_(eps))
                pf = p.float()
                upd.add_(weight_decay * pf)
                p.copy_(pf - upd.mul_(lr_f))   # cast to p's dtype
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
            zeros = lambda s: torch.zeros(s, dtype=torch.float32,  # noqa: E731
                                          device=p.device)
            if p.dim() >= 2:
                return {"r": zeros(p.shape[:-1]),                  # row sums
                        "c": zeros(p.shape[:-2] + p.shape[-1:])}
            return {"v": zeros(p.shape)}
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
