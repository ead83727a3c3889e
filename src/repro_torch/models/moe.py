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

Under a mesh (``sharding.use_rules`` with DTensor weights) the two
expert-parallel branches of the reference run in ``local_map`` with
functional collectives: the model-axis branch (experts split over
``model``; each rank routes its tokens, runs its local experts and the
partial outputs are summed over ``model``), and ``_moe_decode_ep``
(experts over the batch axes, as ``decode_moe`` rules put them: the tokens
are all-gathered over those axes, each rank runs its experts, sums over
``model`` where the expert hidden dim is split there, and reduce-scatters
the outputs back).  As in the reference, each rank's capacity counts its
own tokens, and the aux loss is the first rank's.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import Partial, Replicate

from repro_torch import sharding as shd
from repro_torch.models import sharded as SH
from repro_torch.models.layers import act_fn, rms_norm
from repro_torch.models.params import Spec
from repro_torch.sharding import gather, is_dtensor, shard

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
                    scales=None, e_lo=0, E_local=None, E_total=None):
    """The assignments of every token to experts [e_lo, e_lo + E_local)
    (all of them by default), through a capacity-C packed buffer with C
    counted for ``E_total`` experts.  xf: (T, d); topw/topi: (T, k).
    Returns the (T, d) partial output in xf's dtype; an assignment to
    another rank's expert adds zero."""
    T, k = topi.shape
    d = xf.shape[-1]
    E = E_local or w_gate.shape[0]
    C = _capacity(T, k, E_total or E, cf)
    dev = xf.device
    flat_e = topi.reshape(-1)
    if E_local is None:
        le = flat_e
    else:
        local = (flat_e >= e_lo) & (flat_e < e_lo + E)
        le = torch.where(local, flat_e - e_lo, E)  # overflow bucket = E
    le_s, order = torch.sort(le, stable=True)
    tok_s = torch.arange(T, device=dev).repeat_interleave(k)[order]
    w_s = topw.reshape(-1)[order]
    # per-expert counts (a static size: E + 1 buckets)
    counts = torch.zeros(E + 1, dtype=le_s.dtype, device=dev).index_add_(
        0, le_s, torch.ones_like(le_s))[:E]
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
    # assignment -> its slot, and whether it kept one (a dropped one, or
    # one to another rank's expert, reads a slot of this rank times 0)
    mine = le_s < E
    le_c = torch.clamp(le_s, max=E - 1)
    rank = torch.arange(T * k, device=dev) - torch.cat(
        [starts, starts.new_full((1,), T * k)])[le_s]
    slot, kept = torch.empty_like(le_s), torch.empty_like(le_s)
    slot[order] = le_c * C + torch.clamp(rank, min=0, max=C - 1)
    kept[order] = ((rank < C) & mine).long()
    slot, kept = slot.reshape(T, k), kept.reshape(T, k).to(o.dtype)
    y = o[slot[:, 0]] * kept[:, :1]
    for j in range(1, k):
        y = y + o[slot[:, j]] * kept[:, j:j + 1]
    return y.to(xf.dtype)


def _resolve_axes(rules, mesh, key):
    """Mesh axes a logical axis maps to (only those present in the mesh)."""
    m = rules.get(key) if rules else None
    names = shd.axis_names(mesh) if mesh is not None else ()
    flat = [a for a in (m if isinstance(m, (tuple, list)) else (m,))
            if a is not None and a in names]
    return tuple(flat)


def _linear_index(axes, mesh):
    """This rank's index over the mesh axes ``axes``, the first major."""
    names = shd.axis_names(mesh)
    return SH.coordinate(mesh, [names.index(a) for a in axes])


def _scales(p, cfg):
    return tuple(p[s] for _, s in _EXPERT_W) \
        if cfg.expert_weights_dtype == "int8" else None


def moe_fwd(p, x, cfg):
    """x: (B,S,d) -> (y, aux_loss)."""
    B, S, d = x.shape
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    act = shd.active() if is_dtensor(h) else None
    if act is not None:
        mesh, rules = act
        E = cfg.n_experts
        ep_axes = _resolve_axes(rules, mesh, "experts")
        batch_axes = _resolve_axes(rules, mesh, "batch")
        if ep_axes and set(ep_axes) & set(batch_axes) and \
                E % shd.mesh_axis_size(mesh, ep_axes) == 0:
            # ---- decode EP: experts spread over the batch-sharded axes ----
            y, aux = _moe_decode_ep(p, h, cfg, mesh, rules, ep_axes)
        else:
            y, aux = _moe_model_ep(p, h, cfg, mesh, rules)
    else:
        hf = h.reshape(B * S, d)
        topw, topi, aux = _route(hf, p["router"], cfg.experts_per_token)
        y = _expert_compute(hf, topw, topi, p["w_gate"], p["w_up"],
                            p["w_down"], cfg.act, cfg.capacity_factor,
                            _scales(p, cfg)).reshape(B, S, d)
    if cfg.n_shared_experts:
        g = h @ gather(p["sh_gate"])
        u = h @ gather(p["sh_up"])
        y = y + (act_fn(cfg.act)(g) * u) @ gather(p["sh_down"])
    return shard(y, "batch", "seq", "embed"), aux


def _grad_partial(mesh, dims):
    return tuple(Partial() if i in dims else Replicate()
                 for i in range(mesh.ndim))


def _moe_model_ep(p, h, cfg, mesh, rules):
    """Experts split over ``model`` (where it divides E; else each rank
    holds all): each rank routes its tokens, runs its local experts and the
    partial outputs are summed over ``model``.  FSDP's split of the expert
    hidden dim over ``data`` is gathered first (per-layer all-gather)."""
    E, k, d = cfg.n_experts, cfg.experts_per_token, cfg.d_model
    names = shd.axis_names(mesh)
    mdims = [names.index("model")] if "model" in names and \
        E % shd.mesh_axis_size(mesh, "model") == 0 else []
    # each token whole on its rank (FSDP's "embed" split would take the
    # data axis wherever the batch does not divide it)
    xp = shd.placements_of(h, ("batch", "seq", None))
    rp = (Replicate(),) * mesh.ndim
    ws = [shd.placements_of(p[w], ("experts", None, None))
          for w, _ in _EXPERT_W]
    if not mdims:
        ws = [rp] * 3
    sc = _scales(p, cfg)
    scp = [shd.logical_to_placements(("experts", None), rules, mesh)
           if mdims else rp for _ in range(3)] if sc else []
    bdims = SH.split_dims(xp, 0, mesh)
    h = SH._to(h, mesh, xp)
    args = [SH._to(p["router"], mesh, rp)] + \
        [SH._to(p[w], mesh, pl) for (w, _), pl in zip(_EXPERT_W, ws)] + \
        ([SH._to(s, mesh, pl) for s, pl in zip(sc, scp)] if sc else [])

    def local_fn(hl, router, wg, wu, wd, *scales):
        Bl, Sl, _ = hl.shape
        hf = hl.reshape(Bl * Sl, d)
        topw, topi, aux = _route(hf, router, k)
        El = wg.shape[0]
        e_lo = SH.coordinate(mesh, mdims) * El if mdims else 0
        y = _expert_compute(hf, topw, topi, wg, wu, wd, cfg.act,
                            cfg.capacity_factor, scales or None, e_lo, El, E)
        if mdims:
            y = SH.all_reduce(y, "sum", mesh, mdims)
            if SH.coordinate(mesh, mdims):
                aux = aux.detach()     # one rank's aux takes the gradient
        return y.reshape(Bl, Sl, d), aux

    return SH.local_map(local_fn, [xp, rp], [xp, rp, *ws, *scp], mesh,
                        [xp, _grad_partial(mesh, bdims + mdims), *ws,
                         *scp])(h, *args)


def _moe_decode_ep(p, h, cfg, mesh, rules, ep_axes):
    """EP where experts live on the batch-sharded axes (decode serving).

    Each EP shard all-gathers the (tiny) token batch across EP axes, runs
    its local experts (hidden dim TP-sharded over "model"), then
    reduce-scatters outputs back to the owning batch shards: one gather and
    one scatter in place of the GPU all-to-all pair."""
    E, k, d = cfg.n_experts, cfg.experts_per_token, cfg.d_model
    names = shd.axis_names(mesh)
    tp = "model" if "model" in names else None
    xp = shd.placements_of(h, ("batch", "seq", None))
    rp = (Replicate(),) * mesh.ndim
    w_in = shd.pspec_to_placements((ep_axes, None, tp), mesh)
    w_out = shd.pspec_to_placements((ep_axes, tp, None), mesh)
    sc = _scales(p, cfg)
    s_in = shd.pspec_to_placements((ep_axes, tp), mesh)
    s_out = shd.pspec_to_placements((ep_axes, None), mesh)
    El = E // shd.mesh_axis_size(mesh, ep_axes)
    ep_dims = [names.index(a) for a in ep_axes]
    h = SH._to(h, mesh, xp)
    args = [SH._to(p["router"], mesh, rp),
            SH._to(p["w_gate"], mesh, w_in), SH._to(p["w_up"], mesh, w_in),
            SH._to(p["w_down"], mesh, w_out)]
    scp = []
    if sc:
        scp = [s_in, s_in, s_out]
        args += [SH._to(s, mesh, pl) for s, pl in zip(sc, scp)]

    def local_fn(hl, router, wg, wu, wd, *scales):
        hg = SH.all_gather(hl, 0, mesh, ep_dims)
        hf = hg.reshape(-1, d)
        topw, topi, aux = _route(hf, router, k)
        e_lo = _linear_index(ep_axes, mesh) * El
        y = _expert_compute(hf, topw, topi, wg, wu, wd, cfg.act,
                            cfg.capacity_factor, scales or None, e_lo, El, E)
        if tp is not None and wg.shape[-1] != cfg.moe_d_ff:
            y = SH.all_reduce(y, "sum", mesh, [names.index(tp)])
        y = y.reshape(hg.shape)
        return SH.reduce_scatter(y, 0, mesh, ep_dims), aux

    return SH.local_map(local_fn, [xp, rp], [xp, rp, w_in, w_in, w_out,
                                             *scp], mesh)(h, *args)


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
