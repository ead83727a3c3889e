"""xLSTM blocks: mLSTM (matrix memory, chunkwise-parallel) and sLSTM
(scalar memory, block-diagonal recurrence): xlstm-1.3b's backbone.

The port of the reference's ``models/xlstm.py``.  mLSTM prefill runs the
stabilized chunkwise form (exponential input gate, sigmoid-in-log-space
forget gate, running max stabilizer m) in fp32; decode is the O(1)
recurrent update on C (B,H,K,V) / n (B,H,K) / m (B,H).  The reference's
three-operand einsums are written as two products each, so no
(B, L, L, H, D) intermediate is made (8.6 GB at full width and chunk 256).

sLSTM is sequential: a Python loop over time with per-head block-diagonal
recurrent weights, exponential gating and the same m stabilizer; its cache
is (c, n, m, h_prev).  Under a mesh the whole recurrence runs as one
batch-parallel ``local_map`` region (``sharded.slstm``), the reference's
``shard_map`` branch of ``slstm_fwd``: the recurrent weights' gradient is
reduced once at the region's boundary, not once a timestep.

Neither has a kernel of the reference's: both are plain torch.  Decode
steps put their new state into the cache dict they are given and return
it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import trace
from repro_torch.models import sharded as SH
from repro_torch.models.layers import _gelu, group_norm_heads, rms_norm
from repro_torch.models.params import Spec
from repro_torch.sharding import gather, is_dtensor, shard, split_heads

CHUNK = 256
PROJ = 2  # mLSTM up-projection factor


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------
def _mdims(cfg):
    di = PROJ * cfg.d_model
    return di, cfg.n_heads, di // cfg.n_heads


def mlstm_specs(cfg):
    d = cfg.d_model
    di, H, dh = _mdims(cfg)
    return {
        "ln": Spec((d,), ("embed",), "zeros"),
        "w_up": Spec((d, 2 * di), ("embed", "inner")),  # -> [x_path, z_gate]
        "wq": Spec((di, H, dh), ("inner", "heads", "head_dim")),
        "wk": Spec((di, H, dh), ("inner", "heads", "head_dim")),
        "wv": Spec((di, H, dh), ("inner", "heads", "head_dim")),
        "w_if": Spec((di, 2 * H), ("inner", "heads"), "small"),  # i,f pre-acts
        "b_if": Spec((2 * H,), ("heads",), "zeros", torch.float32),
        "out_gn": Spec((H, dh), ("heads", "head_dim"), "ones"),
        "w_down": Spec((di, d), ("inner", "embed")),
    }


def mlstm_cache_spec(cfg, B):
    _, H, dh = _mdims(cfg)
    return {
        "C": Spec((B, H, dh, dh),
                  ("cache_batch", "ssm_heads", "head_dim", "state"), "zeros",
                  torch.float32),
        "n": Spec((B, H, dh), ("cache_batch", "ssm_heads", "head_dim"),
                  "zeros", torch.float32),
        "m": Spec((B, H), ("cache_batch", "ssm_heads"), "zeros",
                  torch.float32),
    }


def _heads(xp, w):
    """xp (B,S,di) @ w (di, H, dh) -> (B,S,H,dh)."""
    di, H, dh = w.shape
    return split_heads(xp @ gather(w).reshape(di, H * dh), H, dh)


def _mlstm_qkvif(p, x, cfg):
    di, H, dh = _mdims(cfg)
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    up = h @ gather(p["w_up"])
    xp, z = up[..., :di], up[..., di:]
    q = _heads(xp, p["wq"]) * (dh ** -0.5)
    k = _heads(xp, p["wk"])
    v = _heads(xp, p["wv"])
    q, k, v = (shard(t, "batch", "seq", "heads", None) for t in (q, k, v))
    gates = (xp @ gather(p["w_if"])).float() + gather(p["b_if"])
    ig, fg = gates[..., :H], gates[..., H:]  # (B,S,H) log-space pre-acts
    logf = -F.softplus(-fg)  # log sigmoid(f)
    return xp, z, q, k, v, ig, logf


def mlstm_chunked(q, k, v, ig, logf, state=None, chunk=CHUNK):
    """Stabilized chunkwise mLSTM. q/k/v: (B,S,H,D); ig/logf: (B,S,H) f32.

    Returns (y (B,S,H,D) in q's dtype, (C,n,m) final state). Matches the
    recurrent form:
      m_t = max(logf_t + m_{t-1}, ig_t)
      C_t = exp(logf_t + m_{t-1} - m_t) C_{t-1} + exp(ig_t - m_t) k_t v_t^T
      n_t likewise; y_t = C_t^T q_t / max(|n_t.q_t|, exp(-m_t))
    """
    B, S, H, D = q.shape
    assert S % chunk == 0, (S, chunk)
    nc = S // chunk
    qc, kc, vc = (t.float().reshape(B, nc, chunk, H, D) for t in (q, k, v))
    igc = ig.reshape(B, nc, chunk, H)
    cumf = torch.cumsum(logf.reshape(B, nc, chunk, H), dim=2)

    if state is None:
        C = torch.zeros((B, H, D, D), dtype=torch.float32, device=q.device)
        n = torch.zeros((B, H, D), dtype=torch.float32, device=q.device)
        m = torch.full((B, H), -1e30, dtype=torch.float32, device=q.device)
    else:
        C, n, m = state

    li = torch.arange(chunk, device=q.device)
    causal = (li[:, None] >= li[None, :])[None, :, :, None]
    ys = []
    for j in range(nc):
        qj, kj, vj, igj, cfj = qc[:, j], kc[:, j], vc[:, j], igc[:, j], \
            cumf[:, j]
        # per-step stabilizer: m_t = cf_t + max(m_in, max_{s<=t}(ig_s - cf_s))
        m_t = cfj + torch.maximum(m[:, None],
                                  torch.cummax(igj - cfj, dim=1).values)
        # intra-chunk weights: exp(cf_t - cf_s + ig_s - m_t), causal
        logw = (cfj[:, :, None] - cfj[:, None, :] + igj[:, None, :]
                - m_t[:, :, None])                          # (B,Lq,Ls,H)
        w = torch.where(causal, torch.exp(logw), torch.zeros_like(logw))
        s = torch.einsum("bqhd,bshd->bqsh", qj, kj)
        y_in = torch.einsum("bqsh,bshd->bqhd", s * w, vj)
        # carry contribution: exp(cf_t + m_in - m_t) * (q_t . C_in)
        wc = torch.exp(cfj + m[:, None] - m_t)                # (B,L,H)
        y_c = torch.einsum("bqhd,bhdk->bqhk", qj, C) * wc[..., None]
        # normalizer n_t = sum_s w k_s + wc * n_in ; denom = max(|n.q|, e^-m)
        n_t = torch.einsum("bqsh,bshd->bqhd", w, kj) + n[:, None] * \
            wc[..., None]
        denom = torch.maximum(
            torch.einsum("bqhd,bqhd->bqh", n_t, qj).abs(), torch.exp(-m_t))
        ys.append((y_in + y_c) / denom[..., None])
        # chunk-end state: m_end = cf_L + max(m_in, max_s(ig_s - cf_s))
        m_end = cfj[:, -1] + torch.maximum(m, (igj - cfj).amax(dim=1))
        wk_end = torch.exp(cfj[:, -1][:, None] - cfj + igj - m_end[:, None])
        fw = torch.exp(cfj[:, -1] + m - m_end)
        kw = kj * wk_end[..., None]
        C = C * fw[..., None, None] + torch.einsum("blhd,blhk->bhdk", kw, vj)
        n = n * fw[..., None] + kw.sum(dim=1)
        m = m_end
    y = torch.stack(ys, dim=1).reshape(B, S, H, D)
    return y.to(q.dtype), (C, n, m)


def mlstm_fwd(p, x, cfg, *, want_cache=False):
    B, S, _ = x.shape
    di = PROJ * cfg.d_model
    xp, z, q, k, v, ig, logf = _mlstm_qkvif(p, x, cfg)
    y, (C, n, m) = mlstm_chunked(q, k, v, ig, logf, chunk=min(CHUNK, S))
    y = group_norm_heads(y, p["out_gn"], cfg.norm_eps)
    # placed as z explicitly, so the gradient that comes back through the
    # product is gathered before the head split's backward
    y = shard(y.reshape(B, S, di), "batch", "seq", "inner") * F.silu(z)
    out = shard(y @ gather(p["w_down"]), "batch", "seq", "embed")
    return out, ({"C": C, "n": n, "m": m} if want_cache else None)


def _mlstm_update(C, n, m, q, k, v, ig, logf):
    """One recurrent step: state C (B,H,K,V), n (B,H,K), m (B,H) and the
    token's q/k/v (B,1,H,D), gates (B,1,H) -> (C, n, m, y (B,H,D))."""
    qf, kf, vf = (t[:, 0].float() for t in (q, k, v))      # (B,H,D)
    ig, logf = ig[:, 0], logf[:, 0]                         # (B,H)
    C = C.float()
    m_new = torch.maximum(logf + m, ig)
    fw = torch.exp(logf + m - m_new)
    iw = torch.exp(ig - m_new)
    C = C * fw[..., None, None] + \
        torch.einsum("bhd,bhk->bhdk", kf, vf) * iw[..., None, None]
    n = n * fw[..., None] + kf * iw[..., None]
    denom = torch.maximum(torch.einsum("bhd,bhd->bh", n, qf).abs(),
                          torch.exp(-m_new))
    y = torch.einsum("bhd,bhdk->bhk", qf, C) / denom[..., None]
    return C, n, m_new, y


def mlstm_step(p, x, cfg, cache):
    """x: (B,1,d); returns (out, the cache dict holding the new state).
    Under a mesh the state update runs on each rank's batch and heads
    (``sharded.region``)."""
    B = x.shape[0]
    di = PROJ * cfg.d_model
    _, H, dh = _mdims(cfg)
    xp, z, q, k, v, ig, logf = _mlstm_qkvif(p, x, cfg)
    args = (cache["C"], cache["n"], cache["m"], q, k, v, ig, logf)
    if is_dtensor(cache["C"]):
        bh = ("cache_batch", "ssm_heads")
        tok = ("batch", "seq", "ssm_heads")
        C, n, m, y = SH.region(
            _mlstm_update, args,
            (bh + ("head_dim", "state"), bh + ("head_dim",), bh,
             tok + (None,), tok + (None,), tok + (None,), tok, tok),
            [((B, H, dh, dh), bh + ("head_dim", "state")),
             ((B, H, dh), bh + ("head_dim",)), ((B, H), bh),
             ((B, H, dh), bh + (None,))])
    else:
        C, n, m, y = _mlstm_update(*args)
    y = group_norm_heads(y[:, None].to(x.dtype), p["out_gn"], cfg.norm_eps)
    y = shard(y.reshape(B, 1, di), "batch", "seq", "inner") * F.silu(z)
    cache["C"], cache["n"], cache["m"] = C, n, m
    return y @ gather(p["w_down"]), cache


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------
def slstm_specs(cfg):
    d = cfg.d_model
    H = cfg.n_heads
    dh = d // H
    return {
        "ln": Spec((d,), ("embed",), "zeros"),
        "w_gates": Spec((d, 4 * d), ("embed", "inner")),  # i,f,z,o inputs
        "r_gates": Spec((H, dh, 4 * dh), ("ssm_heads", "head_dim", "inner"),
                        "small"),
        "b_gates": Spec((4 * d,), ("inner",), "zeros", torch.float32),
        "out_gn": Spec((H, dh), ("heads", "head_dim"), "ones"),
        # post-block gated FFN (4/3 factor, GELU) per xLSTM paper
        "ffn_ln": Spec((d,), ("embed",), "zeros"),
        "ffn_up": Spec((d, (4 * d) // 3 * 2), ("embed", "mlp")),
        "ffn_down": Spec(((4 * d) // 3, d), ("mlp", "embed")),
    }


def slstm_cache_spec(cfg, B):
    H = cfg.n_heads
    dh = cfg.d_model // H
    ax = ("cache_batch", "ssm_heads", "head_dim")
    return {k: Spec((B, H, dh), ax, "zeros", torch.float32)
            for k in ("c", "n", "m", "hp")}


def _slstm_cell(r_gates, xg, state, H, dh):
    """One timestep. xg: (B, 4d) input pre-acts; state: (c,n,m,hp) (B,H,dh)."""
    c, n, m, hp = state
    B = xg.shape[0]
    rec = torch.einsum("bhd,hdg->bhg", hp.to(r_gates.dtype), r_gates)
    g = xg.reshape(B, H, 4 * dh).float() + rec.float()
    ii, ff, zz, oo = g.chunk(4, dim=-1)  # (B,H,dh) each
    m_new = torch.maximum(ff + m, ii)  # exp forget gating, stabilized
    iw = torch.exp(ii - m_new)
    fw = torch.exp(ff + m - m_new)
    c = fw * c + iw * torch.tanh(zz)
    n = fw * n + iw
    h = torch.sigmoid(oo) * c / torch.clamp(n, min=1.0)
    return c, n, m_new, h


def _slstm_scan(xg, r_gates, H, dh):
    """The sequential recurrence over time. xg: (B,S,4d) f32 pre-acts.
    Returns ((c, n, m, h) at the last step, hs (S,B,H,dh)).  Traced on
    meta tensors (the mesh dry run), one step stands for all S
    (``_TracedScan``)."""
    if trace.tracing_meta(xg.device):
        *st, hs = _TracedScan.apply(xg, r_gates, H, dh)
        return tuple(st), hs
    B = xg.shape[0]
    z0 = torch.zeros((B, H, dh), dtype=torch.float32, device=xg.device)
    st = (z0, z0, torch.full_like(z0, -1e30), z0)
    hs = []
    for t in range(xg.shape[1]):
        st = _slstm_cell(r_gates, xg[:, t], st, H, dh)
        hs.append(st[3])
    return st, torch.stack(hs)


def _scan_state(B, H, dh, device):
    z0 = torch.zeros((B, H, dh), dtype=torch.float32, device=device)
    return (z0, z0, torch.full_like(z0, -1e30), z0)


class _TracedScan(torch.autograd.Function):
    """The sLSTM scan as the dry run traces it on meta tensors: one step,
    its operators counted S times (``trace.repeated``); the hidden states
    allocated whole, and the tensors autograd saves a step allocated S
    times over and saved for backward, so the traced peak holds what the
    real scan holds (and remat drops it as it drops the real ones).  The
    backward runs one step's gradient, counted S times, after a recompute
    counted none."""

    @staticmethod
    def forward(ctx, xg, r_gates, H, dh):
        from torch.autograd.graph import saved_tensors_hooks
        B, S = xg.shape[:2]
        per_step = [0]

        def pack(t):
            per_step[0] += t.numel() * t.element_size()
            return t
        with torch.enable_grad(), saved_tensors_hooks(pack, lambda t: t), \
                trace.repeated(S):
            st = _slstm_cell(r_gates.detach().requires_grad_(),
                             xg[:, 0].detach().requires_grad_(),
                             _scan_state(B, H, dh, xg.device), H, dh)
        held = torch.empty((S * per_step[0],), dtype=torch.uint8,
                           device=xg.device)
        ctx.save_for_backward(xg, r_gates, held)
        ctx.H, ctx.dh = H, dh
        hs = torch.empty((S, B, H, dh), dtype=torch.float32,
                         device=xg.device)
        return (*(t.detach() for t in st), hs)

    @staticmethod
    def backward(ctx, *grads):
        xg, r_gates, _ = ctx.saved_tensors
        B, S = xg.shape[:2]
        with torch.enable_grad():
            xs = xg[:, 0].detach().requires_grad_()
            r = r_gates.detach().requires_grad_()
            with trace.repeated(0):
                h = _slstm_cell(r, xs, _scan_state(B, ctx.H, ctx.dh,
                                                   xg.device),
                                ctx.H, ctx.dh)[3]
            with trace.repeated(S):
                _, gr = torch.autograd.grad(h, (xs, r), grads[4][0])
        return torch.empty_like(xg), gr, None, None


def _gates_in(p, x, cfg):
    return (rms_norm(x, p["ln"], cfg.norm_eps) @ gather(p["w_gates"])
            ).float() + gather(p["b_gates"])


def _slstm_out(p, x, h, cfg):
    """The sLSTM block's output from its hidden states h (B,S,H,dh) f32:
    group norm, then the gated FFN on x + y."""
    B, S = h.shape[:2]
    y = group_norm_heads(h.to(x.dtype), p["out_gn"], cfg.norm_eps)
    y = y.reshape(B, S, cfg.d_model)
    up = rms_norm(x + y, p["ffn_ln"], cfg.norm_eps) @ gather(p["ffn_up"])
    half = up.shape[-1] // 2
    return y + (_gelu(up[..., :half]) * up[..., half:]) @ \
        gather(p["ffn_down"])


def slstm_fwd(p, x, cfg, *, want_cache=False):
    H = cfg.n_heads
    dh = cfg.d_model // H
    xg = _gates_in(p, x, cfg)
    if is_dtensor(xg):
        (c, n, m, hp), hs = SH.slstm(_slstm_scan, xg, p["r_gates"], H, dh)
    else:
        (c, n, m, hp), hs = _slstm_scan(xg, p["r_gates"], H, dh)
    out = _slstm_out(p, x, hs.transpose(0, 1), cfg)
    return out, ({"c": c, "n": n, "m": m, "hp": hp} if want_cache else None)


def slstm_step(p, x, cfg, cache):
    """x: (B,1,d); returns (out, the cache dict holding the new state)."""
    H = cfg.n_heads
    dh = cfg.d_model // H
    st = (cache["c"], cache["n"], cache["m"], cache["hp"])
    xg = _gates_in(p, x, cfg)[:, 0]
    if is_dtensor(cache["c"]):
        c, n, m, h = SH.slstm_step(_slstm_cell, gather(p["r_gates"]), xg, st,
                                   dh)
    else:
        c, n, m, h = _slstm_cell(p["r_gates"], xg, st, H, dh)
    cache["c"], cache["n"], cache["m"], cache["hp"] = c, n, m, h
    return _slstm_out(p, x, h[:, None], cfg), cache
