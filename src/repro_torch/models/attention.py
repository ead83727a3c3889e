"""Attention: GQA over a full sequence (prefill) and against a cache (decode).

The port of the reference's ``models/attention.py``, GQA part.
``gqa_fwd`` sends causal full-sequence attention with no window through
``ops.flash_attention`` at every length: the reference's two branches
there (``plain_attention`` and ``flash_attention_jnp``) compute the same
function as the flash kernel when Sq = Sk (the kernel's plain version,
``kernels.flash_attention.flash_attention_plain``, is ``plain_attention``
with the kernel's masks).  ``gqa_step`` (one token against the cache)
stays plain torch, as the reference has no kernel for it; it writes the
new key and value into the cache in place and returns the same cache
dict, so a decode step does not copy the cache.

Not ported yet: MLA (with the MoE family), cross-attention and the
bidirectional encoder (audio), the banded sliding-window path (gemma3)
and the int8 KV cache; each raises or is absent, naming its ROADMAP item
(Queue 1 item 9).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope, rms_norm
from repro_torch.models.params import Spec

NEG = -2.0e38


def _todo(what: str):
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP Queue 1 "
                              "item 9)")


# ---------------------------------------------------------------------------
# Param and cache specs
# ---------------------------------------------------------------------------
def gqa_specs(cfg, d=None):
    d = d or cfg.d_model
    dh, H, Kh = cfg.dh, cfg.n_heads, cfg.n_kv_heads
    return {
        "ln": Spec((d,), ("embed",), "zeros"),
        "wq": Spec((d, H, dh), ("embed", "heads", "head_dim")),
        "wk": Spec((d, Kh, dh), ("embed", "kv_heads", "head_dim")),
        "wv": Spec((d, Kh, dh), ("embed", "kv_heads", "head_dim")),
        "wo": Spec((H, dh, d), ("heads", "head_dim", "embed")),
    }


def cache_spec_gqa(cfg, B, T, window=0):
    if window:
        _todo("the sliding-window KV cache")
    if cfg.kv_cache_dtype == "int8":
        _todo("the int8 KV cache")
    dh, Kh = cfg.dh, cfg.n_kv_heads
    ax = ("cache_batch", "cache_seq", "kv_heads", "head_dim")
    return {
        "k": Spec((B, T, Kh, dh), ax, "zeros"),
        "v": Spec((B, T, Kh, dh), ax, "zeros"),
        "pos": Spec((B, T), ax[:2], "zeros", torch.int32),
    }


# ---------------------------------------------------------------------------
# Core attention math
# ---------------------------------------------------------------------------
def _grouped_scores(q, k, out_dtype=torch.float32):
    """q: (B,Sq,H,D), k: (B,Sk,Kh,D) -> (B, Kh, G, Sq, Sk) in f32.

    ``out_dtype`` is the product's result type, as the reference's
    ``preferred_element_type``: decode passes the cache's dtype, so bf16
    scores are rounded to bf16 before the upcast, as there."""
    B, Sq, H, D = q.shape
    Kh = k.shape[2]
    qg = q.reshape(B, Sq, Kh, H // Kh, D)
    if out_dtype == torch.float32:
        qg, k = qg.float(), k.float()
    return torch.einsum("bqkgd,bskd->bkgqs", qg, k).float()


def _apply_probs(p, v):
    """p: (B,Kh,G,Sq,Sk) f32, v: (B,Sk,Kh,D) -> (B,Sq,H,D) in v's dtype."""
    B, Kh, G, Sq, Sk = p.shape
    o = torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype), v)
    return o.reshape(B, Sq, Kh * G, v.shape[-1])


# ---------------------------------------------------------------------------
# GQA layer
# ---------------------------------------------------------------------------
def _proj(h, w):
    """h (B,S,d) @ w (d, heads, dh) -> (B,S,heads,dh)."""
    d, n, dh = w.shape
    return (h @ w.reshape(d, n * dh)).reshape(*h.shape[:2], n, dh)


def _qkv(p, x, cfg, theta, pos):
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    q = _proj(h, p["wq"])
    k = _proj(h, p["wk"])
    v = _proj(h, p["wv"])
    if theta:
        q = apply_rope(q, pos, theta)
        k = apply_rope(k, pos, theta)
    return q, k, v


def _out(o, wo):
    """o (B,S,H,dh) @ wo (H, dh, d) -> (B,S,d)."""
    H, dh, d = wo.shape
    return o.reshape(*o.shape[:2], H * dh) @ wo.reshape(H * dh, d)


def gqa_fwd(p, x, cfg, *, theta, window=0, want_cache=False):
    if window:
        _todo("sliding-window attention (the banded path)")
    if cfg.kv_cache_dtype == "int8" and want_cache:
        _todo("the int8 KV cache")
    B, S, _ = x.shape
    pos = torch.arange(S, device=x.device)
    q, k, v = _qkv(p, x, cfg, theta, pos)
    o = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=True)
    y = _out(o.transpose(1, 2), p["wo"])
    cache = None
    if want_cache:
        cache = {"k": k, "v": v,
                 "pos": pos.to(torch.int32).expand(B, S).contiguous()}
    return y, cache


def gqa_step(p, x, cfg, cache, pos, *, theta, window=0):
    """x: (B,1,d); cache k/v: (B,T,Kh,D), written in place at slot
    ``min(pos, T - 1)``; returns (y, the same cache dict)."""
    if window:
        _todo("sliding-window attention (the banded path)")
    if "k_s" in cache:
        _todo("the int8 KV cache")
    posv = torch.full((x.shape[0], 1), int(pos), dtype=torch.int32,
                      device=x.device)
    q, k, v = _qkv(p, x, cfg, theta, posv)
    ck, cv, cpos = cache["k"], cache["v"], cache["pos"]
    slot = min(int(pos), ck.shape[1] - 1)
    ck[:, slot] = k[:, 0].to(ck.dtype)
    cv[:, slot] = v[:, 0].to(cv.dtype)
    cpos[:, slot] = int(pos)
    valid = cpos <= int(pos)
    s = _grouped_scores(q, ck, out_dtype=ck.dtype) * (cfg.dh ** -0.5)
    s = torch.where(valid[:, None, None, None, :], s, torch.full_like(s, NEG))
    o = _apply_probs(torch.softmax(s, dim=-1), cv)
    return _out(o, p["wo"]), cache
