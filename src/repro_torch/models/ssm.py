"""Mamba-2 (SSD) blocks: zamba2's backbone.

The port of the reference's ``models/ssm.py``.  Prefill runs the chunked
SSD scan through ``ops.mamba2_ssd`` (the hand-written kernel on the card)
where the reference calls its jnp ``ssd_chunked``: both compute the chunked
SSD with a zero initial state, chunk ``min(256, S)``.  As there, y is cast
to the input's dtype, the ``D`` skip is added outside the scan, and the
final state goes to the cache.  Decode is the O(1)-state recurrent step.
State layout: h (B, H, P, N) with P = headdim, N = ssm_state.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models import sharded as SH
from repro_torch.models.layers import rms_norm
from repro_torch.models.params import Spec
from repro_torch.sharding import gather, is_dtensor, shard, split_heads


def _dims(cfg):
    di = cfg.ssm_expand * cfg.d_model
    return di, di // cfg.ssm_headdim, cfg.ssm_headdim, cfg.ssm_state


def mamba2_specs(cfg):
    d = cfg.d_model
    di, H, _, N = _dims(cfg)
    K = cfg.ssm_conv
    conv_ch = di + 2 * N  # x, B, C go through the causal conv
    return {
        "ln": Spec((d,), ("embed",), "zeros"),
        # in_proj -> [z (di), xBC (conv_ch), dt (H)]
        "w_in": Spec((d, 2 * di + 2 * N + H), ("embed", "inner")),
        "conv_w": Spec((K, conv_ch), ("conv", "inner"), "small"),
        "conv_b": Spec((conv_ch,), ("inner",), "zeros"),
        "A_log": Spec((H,), ("ssm_heads",), "ones", torch.float32),
        "D": Spec((H,), ("ssm_heads",), "ones", torch.float32),
        "dt_bias": Spec((H,), ("ssm_heads",), "zeros", torch.float32),
        "out_ln": Spec((di,), ("inner",), "zeros"),
        "w_out": Spec((di, d), ("inner", "embed")),
    }


def mamba2_cache_spec(cfg, B):
    di, H, P, N = _dims(cfg)
    K = cfg.ssm_conv
    return {
        "conv": Spec((B, K - 1, di + 2 * N), ("cache_batch", "conv", "inner"),
                     "zeros"),
        "h": Spec((B, H, P, N),
                  ("cache_batch", "ssm_heads", "head_dim", "state"), "zeros",
                  torch.float32),
    }


def _split_in(p, x, cfg):
    di, _, _, N = _dims(cfg)
    zxbcdt = rms_norm(x, p["ln"], cfg.norm_eps) @ gather(p["w_in"])
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di: di + di + 2 * N]
    dt = zxbcdt[..., di + di + 2 * N:]
    return z, xbc, dt


def _causal_conv(xbc, w, b):
    """Depthwise causal conv. xbc: (B,S,C); w: (K,C). Returns (B,S,C)."""
    K, S = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, K - 1, 0))
    out = torch.zeros_like(xbc)
    for k in range(K):  # K=4: unrolled taps, as the reference
        out = out + pad[:, k: k + S] * w[k]
    return F.silu(out + b)


def mamba2_fwd(p, x, cfg, *, want_cache=False):
    B, S, d = x.shape
    di, H, P, N = _dims(cfg)
    z, xbc, dt = _split_in(p, x, cfg)
    xbc = _causal_conv(xbc, p["conv_w"], p["conv_b"])
    xs, Bm, Cm = xbc[..., :di], xbc[..., di: di + N], xbc[..., di + N:]
    dtf = F.softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    xh = shard(split_heads(xs, H, P), "batch", "seq", "ssm_heads", None)
    if is_dtensor(xh):
        y, hN = SH.ssd(ops.mamba2_ssd, xh, dtf, A, Bm, Cm)
    else:
        y, hN = ops.mamba2_ssd(xh, dtf, A, Bm, Cm)
    y = y.to(xh.dtype)
    y = y + xh * p["D"][None, None, :, None].to(y.dtype)
    y = y.reshape(B, S, di)
    y = rms_norm(y * F.silu(z), p["out_ln"], cfg.norm_eps)
    out = shard(y @ gather(p["w_out"]), "batch", "seq", "embed")
    cache = None
    if want_cache:
        # the conv cache holds the last K-1 positions' pre-conv projections
        K = cfg.ssm_conv
        tail = rms_norm(x[:, S - (K - 1):], p["ln"], cfg.norm_eps)
        cache = {"conv": (tail @ gather(p["w_in"]))[..., di: di + di + 2 * N],
                 "h": hN}
    return out, cache


def _ssm_step(h, xh, Bv, Cv, dtf, A, D):
    """The recurrent update: h (B,H,P,N) fp32 decayed by exp(dt A) plus
    dt x B^T; y = h C + D x (B,H,P) fp32."""
    a = torch.exp(dtf * A)                                    # (B,H)
    h = h * a[:, :, None, None] + torch.einsum(
        "bhp,bn,bh->bhpn", xh, Bv, dtf)
    y = torch.einsum("bhpn,bn->bhp", h, Cv) + xh * D[None, :, None]
    return h, y


def mamba2_step(p, x, cfg, cache):
    """x: (B,1,d). cache: {conv (B,K-1,C), h (B,H,P,N)}; returns (out, the
    same cache dict holding the new conv window and state).  Under a mesh
    the state update runs on each rank's batch and heads
    (``sharded.region``)."""
    B = x.shape[0]
    di, H, P, N = _dims(cfg)
    z, xbc_new, dt = _split_in(p, x, cfg)
    window = torch.cat([cache["conv"], xbc_new], dim=1)       # (B,K,C)
    conv_out = F.silu(torch.einsum("bkc,kc->bc", window, gather(p["conv_w"]))
                      + gather(p["conv_b"]))[:, None]
    xs, Bm, Cm = (conv_out[..., :di], conv_out[..., di: di + N],
                  conv_out[..., di + N:])
    dtf = F.softplus(dt.float() + p["dt_bias"])[:, 0]         # (B,H)
    A = -torch.exp(p["A_log"])
    xh = split_heads(xs, H, P)[:, 0].float()
    Bv = Bm[:, 0].float()                                     # (B,N)
    Cv = Cm[:, 0].float()
    args = (cache["h"], xh, Bv, Cv, dtf, A, p["D"])
    if is_dtensor(cache["h"]):
        hx = ("cache_batch", "ssm_heads")
        h, y = SH.region(
            _ssm_step, args,
            (hx + ("head_dim", "state"), hx + (None,), ("cache_batch", None),
             ("cache_batch", None), hx, ("ssm_heads",), ("ssm_heads",)),
            [((B, H, P, N), hx + ("head_dim", "state")),
             ((B, H, P), hx + (None,))])
    else:
        h, y = _ssm_step(*args)
    y = y.reshape(B, 1, di).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["out_ln"], cfg.norm_eps)
    cache["conv"], cache["h"] = window[:, 1:], h
    return y @ gather(p["w_out"]), cache
