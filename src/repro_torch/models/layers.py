"""Shared primitives: norms, RoPE, sinusoid positions, gated MLP,
embeddings.

The port of the reference's ``models/layers.py``, with its losses.  Casts
follow the reference: norms compute in fp32 and return the input's dtype,
RoPE rotates in fp32, matmuls keep their operands' dtype (a bf16 product
accumulates in fp32 and rounds once).

Under a mesh (``sharding.use_rules`` with DTensor weights) the ``shard``
calls sit where the reference's do, and each weight is first brought to
its placements without the FSDP axis (``sharding.gather``): the
per-use all-gather of ZeRO-3.  Outside a mesh both are the identity.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models.params import Spec
from repro_torch.sharding import (gather, is_dtensor, shard,
                                  under_current_rules)


def rms_norm(x, w, eps=1e-6):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + gather(w).float())).to(dt)


def layer_norm(x, w, b, eps=1e-5):
    """No model of the reference calls it; kept with the other norms."""
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * w.float() + b.float()).to(dt)


def group_norm_heads(x, w, eps=1e-6):
    """Per-head group norm over the last dim. x: (..., H, D)."""
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    return ((x - mu) * torch.rsqrt(var + eps) * gather(w).float()).to(dt)


def _gelu(x):
    return F.gelu(x, approximate="tanh")        # jax.nn.gelu's default


def act_fn(name: str):
    return {"silu": F.silu, "gelu": _gelu, "relu": F.relu}[name]


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def rope_freqs(dh: int, theta: float, device=None):
    return theta ** (-torch.arange(0, dh, 2, dtype=torch.float32,
                                   device=device) / dh)


def apply_rope(x, pos, theta: float):
    """x: (B, S, H, D); pos: (B, S) or (S,) int positions.  Half-split
    rotation (the first D/2 features pair with the last D/2)."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)                 # (D/2,)
    angles = pos[..., None].float() * freqs                 # (..., S, D/2)
    if angles.dim() == 2:                   # (S, D/2) -> broadcast batch
        angles = angles[None]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoid_pos_emb(S: int, d: int, offset=0, device=None):
    """(S, d) fp32: [sin | cos] of positions offset .. offset + S - 1."""
    pos = torch.arange(offset, offset + S, dtype=torch.float32,
                       device=device)[:, None]
    # the fp32 exponents' powers rounded once from fp64, as the reference's
    # pow gives them: torch's fp32 pow is an ulp off for some, which moves
    # the angle at position 1500 by ~1e-4
    inv = (1e4 ** (-torch.arange(0, d, 2, dtype=torch.float32,
                                 device=device) / d).double()).float()
    ang = pos * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# Gated MLP
# ---------------------------------------------------------------------------
def mlp_specs(d: int, ff: int):
    return {
        "ln": Spec((d,), ("embed",), "zeros"),
        "w_gate": Spec((d, ff), ("embed", "mlp")),
        "w_up": Spec((d, ff), ("embed", "mlp")),
        "w_down": Spec((ff, d), ("mlp", "embed")),
    }


def mlp_fwd(p, x, act="silu", eps=1e-6):
    h = rms_norm(x, p["ln"], eps)
    g = h @ gather(p["w_gate"])
    u = h @ gather(p["w_up"])
    g = shard(act_fn(act)(g) * u, "batch", "seq", "mlp")
    return shard(g @ gather(p["w_down"]), "batch", "seq",
                 "embed")


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------
def embed_specs(vocab: int, d: int, tie: bool):
    s = {"tok": Spec((vocab, d), ("vocab", "embed_table"))}
    if not tie:
        s["head"] = Spec((d, vocab), ("embed", "vocab"))
    return s


def embed_scale(d: int) -> float:
    """sqrt(d) rounded to bf16, as the reference scales (50.5 at d=2560)."""
    return float(torch.tensor(math.sqrt(float(d)), dtype=torch.float32)
                 .to(torch.bfloat16))


def embed(p, tokens, d):
    tok = p["tok"]
    x = F.embedding(tokens, tok) * torch.tensor(
        embed_scale(d), dtype=tok.dtype, device=tok.device)
    return shard(x, "batch", "seq", "embed")


def head_matrix(p):
    """The unembedding (d, V): ``head``, or the tied table transposed; under
    a mesh without its FSDP axis."""
    w = p.get("head")
    return gather(p["tok"]).T if w is None else gather(w)


def unembed(p, x):
    return shard(x @ head_matrix(p), "batch", "seq", "vocab")


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------
def _label_nll(logits, labels):
    """(logZ - logit of the label) per position, in fp32.  The label's
    logit is gathered: the reference sums the logits against a one-hot,
    which adds exact zeros to the same value."""
    if is_dtensor(logits):
        from repro_torch.models import sharded
        return sharded.label_nll(_label_nll, logits, labels)
    logits = logits.float()
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.logsumexp(logits, dim=-1) - ll


def softmax_xent(logits, labels, mask=None):
    """Mean next-token CE in f32. logits: (B,S,V); labels: (B,S)."""
    nll = _label_nll(logits, labels)
    if mask is None:
        return torch.mean(nll)
    mask = mask.float()
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


def softmax_xent_fused(embed_p, x, labels, mask=None, chunk=512):
    """Fused unembed + CE that never holds the (B, S, V) fp32 logits whole:
    ``chunk`` positions at a time, each chunk's logits (B, chunk, V) made,
    reduced to its summed NLL and mask count, and dropped.  Where autograd
    records, each chunk runs under ``torch.utils.checkpoint``, so backward
    recomputes its logits instead of storing them (the reference's
    ``jax.checkpoint``'d chunk body; here the remainder's chunk too).
    Chunks are summed in order, then the remainder, as the reference's
    scan."""
    W = head_matrix(embed_p)                       # (d, V)
    S = x.shape[1]
    c = min(chunk, S)
    if mask is None:
        mask = torch.ones_like(labels)

    def chunk_loss(xc, lc, mc):
        nll = _label_nll(shard(xc @ W, "batch", "seq", "vocab"), lc)
        m = mc.float()
        return torch.sum(nll * m), torch.sum(m)

    grad = torch.is_grad_enabled()
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, S, c):
        args = (x[:, i:i + c], labels[:, i:i + c], mask[:, i:i + c])
        if grad:
            dt, dn = checkpoint(under_current_rules(chunk_loss), *args,
                                use_reentrant=False)
        else:
            dt, dn = chunk_loss(*args)
        tot, cnt = tot + dt, cnt + dn
    return tot / torch.clamp(cnt, min=1.0)
