"""Attention: GQA (full, sliding-window and bidirectional), MLA and cross
attention, over a full sequence (prefill) and against a cache (decode).

The port of the reference's ``models/attention.py``.  ``gqa_fwd``,
``mla_fwd`` and ``cross_fwd`` send full-sequence attention through
``ops.flash_attention`` at every length, a sliding window and the
non-causal encoder and cross attention included: the reference's branches
there (``plain_attention`` with a causal, window or all-true mask,
``flash_attention_jnp`` and ``banded_attention``) compute the same
function as the flash kernel (its plain version,
``kernels.flash_attention.flash_attention_plain``, is ``plain_attention``
with the kernel's masks; a causal call has Sq = Sk, so the kernel's
left-aligned mask is the reference's).  The reference's ``cross_fwd``
takes its chunked path only where Sq * Sk >= 2^21; the port calls the
kernel at any size.  MLA prefill expands the latent into per-head keys
[k_nope | k_rope] (D = qk_nope + qk_rope) and values (Dv = v_head_dim)
and runs the kernel at (D, Dv); the kernel's scale D^-1/2 is the
reference's (qk_nope + qk_rope)^-1/2.

``gqa_step``, ``mla_step`` and ``cross_step`` (one token against the
cache) stay plain torch, as the reference has no kernel for them;
``gqa_step`` and ``mla_step`` write the new entry into the cache in place
and return the same cache dict, so a decode step does not copy the cache.
A sliding-window layer's cache is a ring of ``min(window, T)`` slots:
prefill leaves the last ``window`` positions with position p at slot
p % window, and a step writes slot ``pos % T`` and masks positions at or
before ``pos - window``.  (The reference rolls the prefill ring by
(-S) % window, which gives that layout only where 2S is a multiple of the
window.)

``kv_cache_dtype="int8"`` keeps the KV (and MLA latent) cache as
symmetric int8 rows with one fp32 scale a (token, head) (``_quant_rows``);
as in the reference, the scales fold into the scores and the
probabilities, so the dequantized cache never materializes.

Under a mesh the ``shard`` calls sit where the reference's do; the flash
kernel and the decode steps' cache work run on each rank's shard
(``models/sharded.py``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models import sharded as SH
from repro_torch.models.layers import apply_rope, rms_norm
from repro_torch.models.params import Spec
from repro_torch.sharding import gather, is_dtensor, shard, split_heads

NEG = -2.0e38


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
    sliding-window layer (a ring), else T; in int8 with their scales
    k_s / v_s (B, W, Kh)."""
    dh, Kh = cfg.dh, cfg.n_kv_heads
    W = min(window, T) if window else T
    ax = ("cache_batch", "cache_seq", "kv_heads", "head_dim")
    if cfg.kv_cache_dtype == "int8":
        return {
            "k": Spec((B, W, Kh, dh), ax, "zeros", torch.int8),
            "k_s": Spec((B, W, Kh), ax[:3], "zeros", torch.float32),
            "v": Spec((B, W, Kh, dh), ax, "zeros", torch.int8),
            "v_s": Spec((B, W, Kh), ax[:3], "zeros", torch.float32),
            "pos": Spec((B, W), ax[:2], "zeros", torch.int32),
        }
    return {
        "k": Spec((B, W, Kh, dh), ax, "zeros"),
        "v": Spec((B, W, Kh, dh), ax, "zeros"),
        "pos": Spec((B, W), ax[:2], "zeros", torch.int32),
    }


def cache_spec_mla(cfg, B, T):
    """The latent cache: ckv (B, T, kv_lora_rank), krope (B, T, qk_rope)
    and pos (B, T); in int8, ckv with its scale ckv_s (B, T)."""
    bt = ("cache_batch", "cache_seq")
    if cfg.kv_cache_dtype == "int8":
        return {
            "ckv": Spec((B, T, cfg.kv_lora_rank), bt + ("kv_lora",),
                        "zeros", torch.int8),
            "ckv_s": Spec((B, T), bt, "zeros", torch.float32),
            "krope": Spec((B, T, cfg.qk_rope_head_dim), bt + ("head_dim",),
                          "zeros"),
            "pos": Spec((B, T), bt, "zeros", torch.int32),
        }
    return {
        "ckv": Spec((B, T, cfg.kv_lora_rank),
                    ("cache_batch", "cache_seq", "kv_lora"), "zeros"),
        "krope": Spec((B, T, cfg.qk_rope_head_dim),
                      ("cache_batch", "cache_seq", "head_dim"), "zeros"),
        "pos": Spec((B, T), ("cache_batch", "cache_seq"), "zeros",
                    torch.int32),
    }


def _quant_rows(x):
    """Symmetric int8 over the last axis. x: (..., D) -> (int8, f32 scale)."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1) / 127.0, min=1e-12)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


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


def _flash(q, k, v, window=0, causal=True):
    """Attention of (B,S,*,D) tensors through the flash kernel, as its
    (B,*,S,D) views: causal (windowed) with Sq = Sk, or non-causal with any
    Sq, Sk; returns (B,Sq,H,Dv).  DTensors (under a mesh) go through
    ``sharded.flash``: the kernel on each rank's shard, in ``local_map``."""
    if is_dtensor(q):
        return SH.flash(_flash, q, k, v, window, causal)
    o = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=causal, window=window)
    return o.transpose(1, 2)


# ---------------------------------------------------------------------------
# GQA layer
# ---------------------------------------------------------------------------
def _proj(h, w, heads="heads"):
    """h (B,S,d) @ w (d, heads, dh) -> (B,S,heads,dh).  h is cast to w's
    dtype: a bf16 input to fp32 weights (whisper's frames in an fp32 run),
    which the reference's einsum promotes so.  ``heads`` names the head
    axis for ``shard``."""
    d, n, dh = w.shape
    y = h.to(w.dtype) @ gather(w).reshape(d, n * dh)
    return shard(split_heads(y, n, dh), "batch", "seq", heads, None)


def _qkv(p, x, cfg, theta, pos):
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    q = _proj(h, p["wq"])
    k = _proj(h, p["wk"], "kv_heads")
    v = _proj(h, p["wv"], "kv_heads")
    if theta:
        q = apply_rope(q, pos, theta)
        k = apply_rope(k, pos, theta)
    return q, k, v


def _out(o, wo):
    """o (B,S,H,dh) @ wo (H, dh, d) -> (B,S,d)."""
    H, dh, d = wo.shape
    y = o.reshape(*o.shape[:2], H * dh) @ gather(wo).reshape(H * dh, d)
    return shard(y, "batch", "seq", "embed")


def gqa_fwd(p, x, cfg, *, theta, window=0, causal=True, want_cache=False):
    B, S, _ = x.shape
    pos = torch.arange(S, device=x.device)
    q, k, v = _qkv(p, x, cfg, theta, pos)
    y = _out(_flash(q, k, v, window, causal), p["wo"])
    cache = None
    if want_cache:
        cpos = pos.to(torch.int32).expand(B, S)
        if window and window < S:
            # the last ``window`` positions, position p at slot
            # p % window, the slot ``gqa_step`` writes
            k, v, cpos = (torch.roll(t[:, S - window:], S % window, dims=1)
                          for t in (k, v, cpos))
        cache = {"k": k, "v": v, "pos": cpos.contiguous()}
        if cfg.kv_cache_dtype == "int8":
            cache["k"], cache["k_s"] = _quant_rows(k)
            cache["v"], cache["v_s"] = _quant_rows(v)
    return y, cache


def gqa_step(p, x, cfg, cache, pos, *, theta, window=0):
    """x: (B,1,d); cache k/v: (B,T,Kh,D) (T = min(window, T) for a local
    layer), written in place at slot ``pos % T`` (a window's ring) or
    ``min(pos, T - 1)``; returns (y, the same cache dict).  An int8 cache
    (``k_s`` in it) takes the new rows quantized; its scores are the dot
    with the int8 keys, then times their scales, and the v scales fold
    into the probabilities, as the reference's.  A cache of DTensors (under
    a mesh) runs the same body on each rank's shard
    (``sharded.cache_decode``)."""
    pos = int(pos)
    posv = torch.full((x.shape[0], 1), pos, dtype=torch.int32,
                      device=x.device)
    q, k, v = _qkv(p, x, cfg, theta, posv)
    T = cache["k"].shape[1]
    slot = pos % T if window else min(pos, T - 1)
    int8_kv = "k_s" in cache
    names = ("k", "v", "pos") + (("k_s", "v_s") if int8_kv else ())

    def attend(qkv, cl, sl, t0, softmax, reduce_ctx):
        q, k, v = qkv
        ck, cv, cpos = cl[:3]
        if sl is not None:
            if int8_kv:
                ck[:, sl], cl[3][:, sl] = _quant_rows(k[:, 0])
                cv[:, sl], cl[4][:, sl] = _quant_rows(v[:, 0])
            else:
                ck[:, sl] = k[:, 0].to(ck.dtype)
                cv[:, sl] = v[:, 0].to(cv.dtype)
            cpos[:, sl] = pos
        valid = cpos <= pos
        if window:
            valid &= cpos > pos - window
        if int8_kv:
            s = _grouped_scores(q, ck.to(q.dtype), out_dtype=q.dtype)
            s = s * cl[3].transpose(1, 2)[:, :, None, None, :]
        else:
            s = _grouped_scores(q, ck, out_dtype=ck.dtype)
        s = s * (cfg.dh ** -0.5)
        s = torch.where(valid[:, None, None, None, :], s,
                        torch.full_like(s, NEG))
        pr = softmax(s)
        if int8_kv:
            # sum_t (p_t v_s_t) v_q_t
            pr = pr * cl[4].transpose(1, 2)[:, :, None, None, :]
            return reduce_ctx(_apply_probs(pr, cv.to(q.dtype)))
        return reduce_ctx(_apply_probs(pr, cv))

    if is_dtensor(cache["k"]):
        kv = ("cache_batch", "cache_seq", "kv_heads", "head_dim")
        o = SH.cache_decode(
            attend, cache, names, (kv, kv, kv[:2], kv[:3], kv[:3]),
            [q, k, v], [("batch", "seq", "heads", None),
                        ("batch", "seq", "kv_heads", None),
                        ("batch", "seq", "kv_heads", None)],
            slot, ("batch", "seq", "heads", None))
    else:
        o = attend((q, k, v), [cache[n] for n in names], slot, 0,
                   lambda s: torch.softmax(s, dim=-1), lambda c: c)
    return _out(o, p["wo"]), cache


# ---------------------------------------------------------------------------
# MLA layer (DeepSeek V2/V3)
# ---------------------------------------------------------------------------
def _mla_qkv_latent(p, x, cfg, pos):
    """(q_nope (B,S,H,dn), q_rope (B,S,H,dr), ckv (B,S,kvr),
    k_rope (B,S,dr)), the rope parts rotated at ``pos``."""
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    dn, kvr = cfg.qk_nope_head_dim, cfg.kv_lora_rank
    cq = rms_norm(h @ gather(p["wdq"]), p["q_ln"], cfg.norm_eps)
    q = _proj(cq, p["wuq"])
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = apply_rope(q_rope, pos, cfg.rope_theta)
    ckv_full = h @ gather(p["wdkv"])
    ckv = rms_norm(ckv_full[..., :kvr], p["kv_ln"], cfg.norm_eps)
    k_rope = apply_rope(ckv_full[..., None, kvr:], pos, cfg.rope_theta)
    return q_nope, q_rope, ckv, k_rope[:, :, 0]


def mla_fwd(p, x, cfg, *, want_cache=False):
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
        if cfg.kv_cache_dtype == "int8":
            cache["ckv"], cache["ckv_s"] = _quant_rows(ckv)
    return y, cache


def mla_step(p, x, cfg, cache, pos, *, absorb=True):
    """x: (B,1,d); the latent cache written in place at slot
    ``min(pos, T - 1)``; returns (y, the same cache dict).  ``absorb``
    folds wuk into the query and wuv after the probabilities (scores
    against the latent cache itself), as the reference's default; else
    the cache is expanded into per-head keys and values.  An int8 latent
    cache (``ckv_s`` in it) is cast to x's dtype; absorbed, its row scales
    fold into the scores and the probabilities, expanded, they multiply
    the latent first, as the reference's.  A cache of DTensors (under a
    mesh) runs the absorbed body on each rank's shard
    (``sharded.cache_decode``)."""
    pos = int(pos)
    B = x.shape[0]
    posv = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q_nope, q_rope, ckv, k_rope = _mla_qkv_latent(p, x, cfg, posv)
    slot = min(pos, cache["ckv"].shape[1] - 1)
    int8_kv = "ckv_s" in cache
    names = ("ckv", "krope", "pos") + (("ckv_s",) if int8_kv else ())
    scale = (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** -0.5

    def write(cl, sl, ckv, k_rope):
        cckv, ckr, cpos = cl[:3]
        if sl is not None:
            if int8_kv:
                cckv[:, sl], cl[3][:, sl] = _quant_rows(ckv[:, 0])
            else:
                cckv[:, sl] = ckv[:, 0].to(cckv.dtype)
            ckr[:, sl] = k_rope[:, 0].to(ckr.dtype)
            cpos[:, sl] = pos
        lat = cckv.to(x.dtype) if int8_kv else cckv
        return lat, ckr, (cpos <= pos)[:, None, None, :]     # (B,1,1,T)

    def attend(args, cl, sl, t0, softmax, reduce_ctx):
        # scores = (q_nope wuk^T) . ckv + q_rope . k_rope, each product in
        # the cache's dtype (bf16 rounded before the upcast, as the
        # reference's preferred_element_type)
        q_lat, q_rope, ckv, k_rope = args
        lat, ckr, valid = write(cl, sl, ckv, k_rope)
        s = torch.einsum("bshr,btr->bhst", q_lat, lat).float()
        if int8_kv:
            s = s * cl[3][:, None, None, :]
        s = s + torch.einsum("bshk,btk->bhst", q_rope, ckr).float()
        s = torch.where(valid, s * scale, torch.full_like(s, NEG))
        pr = softmax(s)
        if int8_kv:
            pr = pr * cl[3][:, None, None, :]
        return reduce_ctx(torch.einsum("bhst,btr->bshr", pr.to(x.dtype),
                                       lat))

    if is_dtensor(cache["ckv"]):
        if not absorb:
            raise ValueError("mla_step: under a mesh only the absorbed form")
        q_lat = torch.einsum("bshk,rhk->bshr", q_nope, gather(p["wuk"]))
        bt = ("cache_batch", "cache_seq")
        ctx = SH.cache_decode(
            attend, cache, names,
            (bt + ("kv_lora",), bt + ("head_dim",), bt, bt),
            [q_lat, q_rope, ckv, k_rope],
            [("batch", "seq", "heads", None), ("batch", "seq", "heads", None),
             ("batch", "seq", None), ("batch", "seq", None)],
            slot, ("batch", "seq", "heads", None))
        o = torch.einsum("bshr,rhk->bshk", ctx, gather(p["wuv"]))
    elif absorb:
        q_lat = torch.einsum("bshk,rhk->bshr", q_nope, p["wuk"])
        ctx = attend((q_lat, q_rope, ckv, k_rope),
                     [cache[n] for n in names], slot, 0,
                     lambda s: torch.softmax(s, dim=-1), lambda c: c)
        o = torch.einsum("bshr,rhk->bshk", ctx, p["wuv"])
    else:
        lat, ckr, valid = write([cache[n] for n in names], slot, ckv,
                                k_rope)
        if int8_kv:
            lat = lat * cache["ckv_s"][..., None].to(x.dtype)
        k_nope = torch.einsum("btr,rhk->bthk", lat, p["wuk"])
        v = torch.einsum("btr,rhk->bthk", lat, p["wuv"])
        k = torch.cat([k_nope, ckr[:, :, None, :].expand(
            *k_nope.shape[:3], ckr.shape[-1])], dim=-1)
        q = torch.cat([q_nope, q_rope], dim=-1)
        s = torch.einsum("bshk,bthk->bhst", q.float(), k.float())
        s = torch.where(valid, s * scale, torch.full_like(s, NEG))
        pr = torch.softmax(s, dim=-1)
        o = torch.einsum("bhst,bthk->bshk", pr.to(v.dtype), v)
    return _out(o, p["wo"]), cache


# ---------------------------------------------------------------------------
# Cross attention (whisper decoder)
# ---------------------------------------------------------------------------
def cross_specs(cfg):
    return gqa_specs(cfg)


def cross_memory(p, memory, cfg):
    """The encoder's output projected to the cross keys and values: dict
    k / v (B, Se, Kh, D), computed once a prefill and kept as the cross
    cache."""
    return {"k": _proj(memory, p["wk"], "kv_heads"),
            "v": _proj(memory, p["wv"], "kv_heads")}


def _cross_q(p, x, cfg):
    return _proj(rms_norm(x, p["ln"], cfg.norm_eps), p["wq"])


def cross_fwd(p, x, memory_kv, cfg):
    """x: (B,S,d); memory_kv: dict k/v (B,Se,Kh,D).  Every query sees every
    key: the flash kernel, non-causal, at Sq = S, Sk = Se."""
    o = _flash(_cross_q(p, x, cfg), memory_kv["k"], memory_kv["v"],
               causal=False)
    return _out(o, p["wo"])


def cross_step(p, x, memory_kv, cfg):
    """``cross_fwd`` for one decode token, in plain torch against the cross
    cache, as the reference's ``cross_fwd`` computes it there
    (``plain_attention``: fp32 scores, probabilities in v's dtype)."""
    q = _cross_q(p, x, cfg)
    s = _grouped_scores(q, memory_kv["k"]) * (cfg.dh ** -0.5)
    o = _apply_probs(torch.softmax(s, dim=-1), memory_kv["v"])
    return _out(o, p["wo"])
