"""Attention: GQA (full and sliding-window) and MLA, over a full sequence
(prefill) and against a cache (decode).

The port of the reference's ``models/attention.py``.  ``gqa_fwd`` and
``mla_fwd`` send causal full-sequence attention through
``ops.flash_attention`` at every length, a sliding window included: the
reference's three branches there (``plain_attention`` with a causal and
window mask, ``flash_attention_jnp`` and ``banded_attention``) compute the
same function as the flash kernel when Sq = Sk (the kernel's plain
version, ``kernels.flash_attention.flash_attention_plain``, is
``plain_attention`` with the kernel's masks).  MLA prefill expands the
latent into per-head keys [k_nope | k_rope] (D = qk_nope + qk_rope) and
values (Dv = v_head_dim) and runs the kernel at (D, Dv); the kernel's
scale D^-1/2 is the reference's (qk_nope + qk_rope)^-1/2.

``gqa_step`` and ``mla_step`` (one token against the cache) stay plain
torch, as the reference has no kernel for them; each writes the new
entry into the cache in place and returns the same cache dict, so a
decode step does not copy the cache.  A sliding-window layer's cache is
a ring of ``min(window, T)`` slots: prefill leaves the last ``window``
positions with position p at slot p % window, and a step writes slot
``pos % T`` and masks positions at or before ``pos - window``.  (The
reference rolls the prefill ring by (-S) % window, which gives that
layout only where 2S is a multiple of the window.)

Not ported yet: cross-attention and the bidirectional encoder (audio)
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


def _no_int8_kv(int8: bool):
    if int8:
        raise NotImplementedError("the int8 KV cache is not ported yet "
                                  "(ROADMAP Queue 1 item 9.6)")


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


def mla_specs(cfg):
    d, H = cfg.d_model, cfg.n_heads
    qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    return {
        "ln": Spec((d,), ("embed",), "zeros"),
        "wdq": Spec((d, qr), ("embed", "q_lora")),
        "q_ln": Spec((qr,), ("q_lora",), "zeros"),
        "wuq": Spec((qr, H, dn + dr), ("q_lora", "heads", "head_dim")),
        "wdkv": Spec((d, kvr + dr), ("embed", "kv_lora")),
        "kv_ln": Spec((kvr,), ("kv_lora",), "zeros"),
        "wuk": Spec((kvr, H, dn), ("kv_lora", "heads", "head_dim")),
        "wuv": Spec((kvr, H, dv), ("kv_lora", "heads", "head_dim")),
        "wo": Spec((H, dv, d), ("heads", "head_dim", "embed")),
    }


def cache_spec_gqa(cfg, B, T, window=0):
    """k / v (B, W, Kh, dh) and pos (B, W), W = min(window, T) for a
    sliding-window layer (a ring), else T."""
    _no_int8_kv(cfg.kv_cache_dtype == "int8")
    dh, Kh = cfg.dh, cfg.n_kv_heads
    W = min(window, T) if window else T
    ax = ("cache_batch", "cache_seq", "kv_heads", "head_dim")
    return {
        "k": Spec((B, W, Kh, dh), ax, "zeros"),
        "v": Spec((B, W, Kh, dh), ax, "zeros"),
        "pos": Spec((B, W), ax[:2], "zeros", torch.int32),
    }


def cache_spec_mla(cfg, B, T):
    """The latent cache: ckv (B, T, kv_lora_rank), krope (B, T, qk_rope)
    and pos (B, T)."""
    _no_int8_kv(cfg.kv_cache_dtype == "int8")
    return {
        "ckv": Spec((B, T, cfg.kv_lora_rank),
                    ("cache_batch", "cache_seq", "kv_lora"), "zeros"),
        "krope": Spec((B, T, cfg.qk_rope_head_dim),
                      ("cache_batch", "cache_seq", "head_dim"), "zeros"),
        "pos": Spec((B, T), ("cache_batch", "cache_seq"), "zeros",
                    torch.int32),
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


def _flash(q, k, v, window=0):
    """Causal (windowed) attention of (B,S,*,D) tensors through the flash
    kernel, as its (B,*,S,D) views; returns (B,S,H,Dv)."""
    o = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=True, window=window)
    return o.transpose(1, 2)


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
    _no_int8_kv(want_cache and cfg.kv_cache_dtype == "int8")
    B, S, _ = x.shape
    pos = torch.arange(S, device=x.device)
    q, k, v = _qkv(p, x, cfg, theta, pos)
    y = _out(_flash(q, k, v, window), p["wo"])
    cache = None
    if want_cache:
        cpos = pos.to(torch.int32).expand(B, S)
        if window and window < S:
            # the last ``window`` positions, position p at slot
            # p % window, the slot ``gqa_step`` writes
            k, v, cpos = (torch.roll(t[:, S - window:], S % window, dims=1)
                          for t in (k, v, cpos))
        cache = {"k": k, "v": v, "pos": cpos.contiguous()}
    return y, cache


def gqa_step(p, x, cfg, cache, pos, *, theta, window=0):
    """x: (B,1,d); cache k/v: (B,T,Kh,D) (T = min(window, T) for a local
    layer), written in place at slot ``pos % T`` (a window's ring) or
    ``min(pos, T - 1)``; returns (y, the same cache dict)."""
    _no_int8_kv("k_s" in cache)
    pos = int(pos)
    posv = torch.full((x.shape[0], 1), pos, dtype=torch.int32,
                      device=x.device)
    q, k, v = _qkv(p, x, cfg, theta, posv)
    ck, cv, cpos = cache["k"], cache["v"], cache["pos"]
    T = ck.shape[1]
    slot = pos % T if window else min(pos, T - 1)
    ck[:, slot] = k[:, 0].to(ck.dtype)
    cv[:, slot] = v[:, 0].to(cv.dtype)
    cpos[:, slot] = pos
    valid = cpos <= pos
    if window:
        valid &= cpos > pos - window
    s = _grouped_scores(q, ck, out_dtype=ck.dtype) * (cfg.dh ** -0.5)
    s = torch.where(valid[:, None, None, None, :], s, torch.full_like(s, NEG))
    o = _apply_probs(torch.softmax(s, dim=-1), cv)
    return _out(o, p["wo"]), cache


# ---------------------------------------------------------------------------
# MLA layer (DeepSeek V2/V3)
# ---------------------------------------------------------------------------
def _mla_qkv_latent(p, x, cfg, pos):
    """(q_nope (B,S,H,dn), q_rope (B,S,H,dr), ckv (B,S,kvr),
    k_rope (B,S,dr)), the rope parts rotated at ``pos``."""
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    dn, kvr = cfg.qk_nope_head_dim, cfg.kv_lora_rank
    cq = rms_norm(h @ p["wdq"], p["q_ln"], cfg.norm_eps)
    q = _proj(cq, p["wuq"])
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = apply_rope(q_rope, pos, cfg.rope_theta)
    ckv_full = h @ p["wdkv"]
    ckv = rms_norm(ckv_full[..., :kvr], p["kv_ln"], cfg.norm_eps)
    k_rope = apply_rope(ckv_full[..., None, kvr:], pos, cfg.rope_theta)
    return q_nope, q_rope, ckv, k_rope[:, :, 0]


def mla_fwd(p, x, cfg, *, want_cache=False):
    _no_int8_kv(want_cache and cfg.kv_cache_dtype == "int8")
    B, S, _ = x.shape
    H, dr = cfg.n_heads, cfg.qk_rope_head_dim
    pos = torch.arange(S, device=x.device)
    q_nope, q_rope, ckv, k_rope = _mla_qkv_latent(p, x, cfg, pos)
    k_nope = _proj(ckv, p["wuk"])
    v = _proj(ckv, p["wuv"])
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, H, dr)],
                  dim=-1)
    y = _out(_flash(q, k, v), p["wo"])
    cache = None
    if want_cache:
        cache = {"ckv": ckv, "krope": k_rope,
                 "pos": pos.to(torch.int32).expand(B, S).contiguous()}
    return y, cache


def mla_step(p, x, cfg, cache, pos, *, absorb=True):
    """x: (B,1,d); the latent cache written in place at slot
    ``min(pos, T - 1)``; returns (y, the same cache dict).  ``absorb``
    folds wuk into the query and wuv after the probabilities (scores
    against the latent cache itself), as the reference's default; else
    the cache is expanded into per-head keys and values."""
    _no_int8_kv("ckv_s" in cache)
    pos = int(pos)
    B = x.shape[0]
    posv = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q_nope, q_rope, ckv, k_rope = _mla_qkv_latent(p, x, cfg, posv)
    cckv, ckr, cpos = cache["ckv"], cache["krope"], cache["pos"]
    slot = min(pos, cckv.shape[1] - 1)
    cckv[:, slot] = ckv[:, 0].to(cckv.dtype)
    ckr[:, slot] = k_rope[:, 0].to(ckr.dtype)
    cpos[:, slot] = pos
    valid = (cpos <= pos)[:, None, None, :]                 # (B,1,1,T)
    scale = (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** -0.5
    if absorb:
        # scores = (q_nope wuk^T) . ckv + q_rope . k_rope, each product in
        # the cache's dtype (bf16 rounded before the upcast, as the
        # reference's preferred_element_type)
        q_lat = torch.einsum("bshk,rhk->bshr", q_nope, p["wuk"])
        s = torch.einsum("bshr,btr->bhst", q_lat, cckv).float()
        s = s + torch.einsum("bshk,btk->bhst", q_rope, ckr).float()
        s = torch.where(valid, s * scale, torch.full_like(s, NEG))
        pr = torch.softmax(s, dim=-1)
        ctx = torch.einsum("bhst,btr->bshr", pr.to(x.dtype), cckv)
        o = torch.einsum("bshr,rhk->bshk", ctx, p["wuv"])
    else:
        k_nope = torch.einsum("btr,rhk->bthk", cckv, p["wuk"])
        v = torch.einsum("btr,rhk->bthk", cckv, p["wuv"])
        k = torch.cat([k_nope, ckr[:, :, None, :].expand(
            *k_nope.shape[:3], ckr.shape[-1])], dim=-1)
        q = torch.cat([q_nope, q_rope], dim=-1)
        s = torch.einsum("bshk,bthk->bhst", q.float(), k.float())
        s = torch.where(valid, s * scale, torch.full_like(s, NEG))
        pr = torch.softmax(s, dim=-1)
        o = torch.einsum("bhst,bthk->bshk", pr.to(v.dtype), v)
    return _out(o, p["wo"]), cache


# ---------------------------------------------------------------------------
# Cross attention (whisper decoder): not ported yet
# ---------------------------------------------------------------------------
def cross_specs(cfg):
    _todo("cross-attention (the audio family)")


def cross_fwd(p, x, memory_kv, cfg):
    _todo("cross-attention (the audio family)")


def cross_memory(p, memory, cfg):
    _todo("cross-attention (the audio family)")
