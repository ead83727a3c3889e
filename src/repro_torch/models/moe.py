"""Mixture-of-Experts (DeepSeek V2/V3 style) on one device.

The port of the reference's ``models/moe.py``, its single-device branch
(``moe_fwd`` outside a mesh): each token is routed to its top-k experts,
the assignments are sorted by expert (stably) and packed into an
(E, C, d) buffer of C static slots an expert, the experts run as batched
products, and the weighted outputs go back to their tokens; then the
shared experts.  Capacity-factor semantics are the reference's: C is the
expected load times ``capacity_factor``, rounded up to a multiple of 8;
assignments past an expert's C slots drop, and empty slots read a zero
pad row.  Routing and the expert products are plain torch: the reference
has no Pallas kernel for them.

int8 experts (``expert_weights_dtype="int8"``, weight-only): the products
run in the activations' dtype against the int8 matrices cast exactly,
then the per-output-column scale applies (the reference's order, ROADMAP
R5).  The cast takes a chunk of experts at a time, so no (E, d, f) stack
in the activations' dtype is ever held whole.

The outputs return to their tokens by a gather (each token's k slots,
summed in the order of its top-k; a dropped assignment adds zero), not a
scatter-add, so a run on the card is deterministic; with k = 2 the sum
rounds as the reference's scatter-add does.

Under autograd (training) the slot weights scale the expert outputs out
of place and the int8 path joins its chunks instead of writing them into
one preallocated buffer; with nothing recorded both stay in place, as
serving wants (the same values either way).  int8 expert matrices take
no gradient.

Not ported: the mesh code (``_moe_decode_ep``, ``_resolve_axes``,
``_linear_index`` and the ``shard_map`` expert-parallel branch), which
ports with the mesh tooling (ROADMAP Queue 1 item 11).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import act_fn, rms_norm
from repro_torch.models.params import Spec

# the most bytes of expert matrices cast out of int8 at once
CAST_BYTES = 1 << 30
_EXPERT_W = (("w_gate", "s_gate"), ("w_up", "s_up"), ("w_down", "s_down"))


def moe_specs(cfg):
    d, E, fe = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    s = {
        "ln": Spec((d,), ("embed",), "zeros"),
        "router": Spec((d, E), ("embed", "experts"), "small", torch.float32),
        "w_gate": Spec((E, d, fe), ("experts", "embed", "expert_mlp")),
        "w_up": Spec((E, d, fe), ("experts", "embed", "expert_mlp")),
        "w_down": Spec((E, fe, d), ("experts", "expert_mlp", "embed")),
    }
    if cfg.expert_weights_dtype == "int8":
        # int8 matrices + per-output-column f32 scales, applied after the
        # product.  An int8 "normal" leaf initialises to zeros (N(0, 0.02^2)
        # cast), as the reference's: quantize_expert_weights makes real ones
        for w in ("w_gate", "w_up", "w_down"):
            s[w] = Spec(s[w].shape, s[w].axes, "normal", torch.int8)
        s["s_gate"] = Spec((E, fe), ("experts", "expert_mlp"), "ones",
                           torch.float32)
        s["s_up"] = Spec((E, fe), ("experts", "expert_mlp"), "ones",
                         torch.float32)
        s["s_down"] = Spec((E, d), ("experts", "embed"), "ones",
                           torch.float32)
    if cfg.n_shared_experts:
        fs = cfg.moe_d_ff * cfg.n_shared_experts
        s.update(
            sh_gate=Spec((d, fs), ("embed", "mlp")),
            sh_up=Spec((d, fs), ("embed", "mlp")),
            sh_down=Spec((fs, d), ("mlp", "embed")),
        )
    return s


def _route(h2d, router, k: int):
    """h2d: (T, d).  Returns top-k weights (T,k) f32, ids (T,k) i64 and the
    load-balancing aux loss.  The top k are taken by a stable descending
    sort, so ties go to the lower expert id, as ``jax.lax.top_k``'s do."""
    gates = torch.softmax(h2d.float() @ router, dim=-1)          # (T, E)
    topw, topi = torch.sort(gates, dim=-1, descending=True, stable=True)
    topw, topi = topw[:, :k], topi[:, :k]
    topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)
    # load-balancing aux: E * sum_e f_e * p_e
    E = gates.shape[-1]
    p_e = gates.mean(0)
    f_e = F.one_hot(topi[:, 0], E).float().mean(0)
    return topw, topi, E * torch.sum(f_e * p_e)


def _capacity(T: int, k: int, E_total: int, cf: float) -> int:
    """Static per-expert slot count: expected load x capacity factor,
    rounded up to a multiple of 8 (the reference's TPU lane alignment)."""
    c = int(-(-T * k * cf // E_total))
    return max(-(-c // 8) * 8, 8)


def _cast_chunk(w, dtype) -> int:
    """Experts of ``w`` (E, a, b) to cast at once within CAST_BYTES."""
    one = w[0].numel() * torch.finfo(dtype).bits // 8
    return max(1, CAST_BYTES // (3 * one))


def _experts(pk, w_gate, w_up, w_down, act, scales=None):
    """pk (E, C, d) through each expert's gated MLP -> (E, C, d)."""
    f = act_fn(act)
    if scales is None:
        h = f(torch.bmm(pk, w_gate)) * torch.bmm(pk, w_up)
        return torch.bmm(h, w_down)
    sg, su, sd = (s[:, None, :].to(pk.dtype) for s in scales)
    n = _cast_chunk(w_gate, pk.dtype)
    # one preallocated output where nothing is recorded; under autograd the
    # chunks are joined, so no slice write hides a version from it
    out = None if torch.is_grad_enabled() else torch.empty(
        pk.shape, dtype=pk.dtype, device=pk.device)
    chunks = []
    for e in range(0, pk.shape[0], n):
        sl = slice(e, e + n)
        g = torch.bmm(pk[sl], w_gate[sl].to(pk.dtype)) * sg[sl]
        u = torch.bmm(pk[sl], w_up[sl].to(pk.dtype)) * su[sl]
        y = torch.bmm(f(g) * u, w_down[sl].to(pk.dtype)) * sd[sl]
        if out is None:
            chunks.append(y)
        else:
            out[sl] = y
    return torch.cat(chunks) if out is None else out


def _expert_compute(xf, topw, topi, w_gate, w_up, w_down, act, cf=1.25,
                    scales=None):
    """The assignments of every token to every expert, through a
    capacity-C packed buffer.  xf: (T, d); topw/topi: (T, k).  Returns
    (T, d) in xf's dtype."""
    T, k = topi.shape
    d, E = xf.shape[-1], w_gate.shape[0]
    C = _capacity(T, k, E, cf)
    dev = xf.device
    le_s, order = torch.sort(topi.reshape(-1), stable=True)
    tok_s = torch.arange(T, device=dev).repeat_interleave(k)[order]
    w_s = topw.reshape(-1)[order]
    counts = torch.bincount(le_s, minlength=E)[:E]
    starts = torch.cumsum(counts, 0) - counts
    # slot -> source assignment (the reference's arithmetic); T is the
    # zero pad row
    slots = torch.arange(E * C, device=dev)
    e_arr, p_arr = slots // C, slots % C
    pos = torch.clamp(starts[e_arr] + p_arr, max=T * k - 1)
    valid = p_arr < torch.clamp(counts[e_arr], max=C)
    src_tok = torch.where(valid, tok_s[pos], T)
    slot_w = torch.where(valid, w_s[pos], 0.0)
    xpad = torch.cat([xf, xf.new_zeros((1, d))])
    o = _experts(xpad[src_tok].reshape(E, C, d), w_gate, w_up, w_down, act,
                 scales).reshape(E * C, d)
    w = slot_w[:, None].to(o.dtype)
    # in place where nothing is recorded; autograd keeps the unscaled o
    o = o * w if torch.is_grad_enabled() else o.mul_(w)
    # assignment -> its slot, and whether it kept one (a dropped one reads
    # its expert's last slot, times 0)
    rank = torch.arange(T * k, device=dev) - starts[le_s]
    slot, kept = torch.empty_like(le_s), torch.empty_like(le_s)
    slot[order] = le_s * C + torch.clamp(rank, max=C - 1)
    kept[order] = (rank < C).long()
    slot, kept = slot.reshape(T, k), kept.reshape(T, k).to(o.dtype)
    y = o[slot[:, 0]] * kept[:, :1]
    for j in range(1, k):
        y = y + o[slot[:, j]] * kept[:, j:j + 1]
    return y.to(xf.dtype)


def moe_fwd(p, x, cfg):
    """x: (B,S,d) -> (y, aux_loss)."""
    B, S, d = x.shape
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    hf = h.reshape(B * S, d)
    topw, topi, aux = _route(hf, p["router"], cfg.experts_per_token)
    sc = tuple(p[s] for _, s in _EXPERT_W) \
        if cfg.expert_weights_dtype == "int8" else None
    y = _expert_compute(hf, topw, topi, p["w_gate"], p["w_up"], p["w_down"],
                        cfg.act, cfg.capacity_factor, sc).reshape(B, S, d)
    if cfg.n_shared_experts:
        g = h @ p["sh_gate"]
        u = h @ p["sh_up"]
        y = y + (act_fn(cfg.act)(g) * u) @ p["sh_down"]
    return y, aux


def quantize_expert_weights(moe_params: dict) -> dict:
    """One MoE subtree's expert weights in the int8 layout: symmetric int8
    per output column with f32 scales.  A serving conversion; pair it with
    ``expert_weights_dtype="int8"``.  Converts a chunk of experts at a
    time, so the f32 copy is never whole."""
    out = dict(moe_params)
    for w, s in _EXPERT_W:
        m = moe_params[w]                                      # (E, in, out)
        q = torch.empty(m.shape, dtype=torch.int8, device=m.device)
        scale = torch.empty((m.shape[0], m.shape[2]), dtype=torch.float32,
                            device=m.device)
        n = _cast_chunk(m, torch.float32)
        for e in range(0, m.shape[0], n):
            mf = m[e:e + n].float()
            sc = torch.clamp(mf.abs().amax(dim=1) / 127.0, min=1e-12)
            q[e:e + n] = torch.clamp(torch.round(mf / sc[:, None, :]),
                                     -127, 127).to(torch.int8)
            scale[e:e + n] = sc
        out[w], out[s] = q, scale
    return out
