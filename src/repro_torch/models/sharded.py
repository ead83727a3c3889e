"""The model's regions that run on each rank's shard under a mesh.

Where the reference leaves a region to XLA's partitioner (the flash and
SSD kernels' inputs, the decode caches) or writes a ``shard_map``, the port
runs it in ``local_map``: DTensor inputs are brought to the placements the
region needs, its body runs plain torch (and the kernels) on the local
tensors, and functional collectives join the ranks where the reference's
``psum`` / ``all_gather`` / ``psum_scatter`` do.  Every region here is
entered only with DTensor inputs under ``sharding.use_rules``; outside a
mesh the model never calls it.

  flash       the flash kernel with batch on the batch axes and heads on
              ``model``.  Where the query heads split over ``model`` and
              the kv heads do not (GQA: tinyllama's 32 over 4 on 8 ranks),
              each rank is given the kv heads its query heads read, so
              local query head i reads local kv head i // (H_local / Kh_local).
  ssd         the SSD kernel with batch on the batch axes and heads on
              ``model``; B and C, shared by every head, go whole to each.
  region      a decode step's recurrent state update (Mamba-2, mLSTM) on
              each rank's batch and heads.
  slstm       the sLSTM scan as one batch-parallel region (the
              reference's ``shard_map``), and ``slstm_step`` its step.
  label_nll   the loss's label log-likelihood over a vocab-split chunk
              of logits (max-shifted logZ and a one-hot, reduced by
              DTensor).
  decode      one token against a KV cache: the slot write, the scores,
              the softmax and the context on each rank's cache; where the
              cache's time axis is split (``decode``: ``model``; ``long``:
              ``data``) the softmax's max and sum and the context are
              reduced over it (flash-decode).  With the time axis whole it
              is the unsharded code itself.

Where no tensor dim is split over more than one rank (a world-1 mesh),
every region runs the unsharded code on the same local tensors, so the
result is bit-identical to the unsharded path's.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import Partial, Replicate, Shard

from repro_torch import sharding as shd


def _wait(t):
    """A functional collective's result, waited for."""
    import torch.distributed._functional_collectives as fc
    return t.wait() if isinstance(t, fc.AsyncCollectiveTensor) else t


def all_reduce(t, op: str, mesh, dims):
    """``t`` reduced (``"sum"`` / ``"max"``) over the mesh dims ``dims``."""
    import torch.distributed._functional_collectives as fc
    for d in dims:
        t = _wait(fc.all_reduce(t, op, (mesh, d)))
    return t


def all_gather(t, dim: int, mesh, dims):
    """``t`` gathered along ``dim`` over the mesh dims ``dims``, the first
    of them major (as ``jax.lax.all_gather(..., tiled=True)`` over each
    in reverse)."""
    import torch.distributed._functional_collectives as fc
    for d in reversed(dims):
        t = _wait(fc.all_gather_tensor(t.contiguous(), dim, (mesh, d)))
    return t


def reduce_scatter(t, dim: int, mesh, dims):
    """``t`` summed over the mesh dims ``dims`` and scattered along
    ``dim``, the first of them major (``psum_scatter`` over each)."""
    import torch.distributed._functional_collectives as fc
    for d in dims:
        t = _wait(fc.reduce_scatter_tensor(t.contiguous(), "sum", dim,
                                           (mesh, d)))
    return t


def split_dims(placements, dim: int, mesh) -> list:
    """The mesh dims (in mesh order) that split tensor dim ``dim``: those
    of more than one rank that shard it."""
    return [i for i, p in enumerate(placements)
            if isinstance(p, Shard) and p.dim == dim and mesh.size(i) > 1]


def coordinate(mesh, dims) -> int:
    """This rank's linear index over the mesh dims ``dims``, the first
    major."""
    coord = mesh.get_coordinate()
    idx = 0
    for d in dims:
        idx = idx * mesh.size(d) + coord[d]
    return idx


def _span(mesh, dims) -> int:
    n = 1
    for d in dims:
        n *= mesh.size(d)
    return n


def _pl(p):
    return None if p is None else list(p)


def local_map(fn, outs, ins, mesh, grads=None):
    """``torch``'s ``local_map`` of ``fn``: ``outs`` the placements of each
    output (the outputs flattened), ``ins`` of each argument, ``grads``
    those of the arguments' gradients (default: as ``ins``)."""
    from torch.distributed.tensor.experimental import local_map as lm
    return lm(fn, out_placements=tuple(_pl(p) for p in outs),
              in_placements=tuple(_pl(p) for p in ins),
              in_grad_placements=None if grads is None else
              tuple(_pl(p) for p in grads),
              device_mesh=mesh)


def _to(x, mesh, pl):
    return x if tuple(x.placements) == tuple(pl) else x.redistribute(mesh, pl)


# ---------------------------------------------------------------------------
# Flash attention
# ---------------------------------------------------------------------------
def flash(attend, q, k, v, window, causal):
    """``attend(q, k, v, window, causal)`` (the unsharded ``_flash``) of
    (B,S,*,D) DTensors on each rank's batch and heads."""
    mesh, rules = shd.active()
    qp = shd.placements_of(q, ("batch", "seq", "heads", None))
    kp = shd.placements_of(k, ("batch", "seq", "kv_heads", None))
    # the kv heads split only as the query heads do
    kd = split_dims(kp, 2, mesh)
    if kd and kd != split_dims(qp, 2, mesh):
        kp = shd.placements_of(k, ("batch", "seq", None, None))
    q, k, v = _to(q, mesh, qp), _to(k, mesh, kp), _to(v, mesh, kp)
    hdims = split_dims(qp, 2, mesh)
    kv_whole = hdims and not split_dims(kp, 2, mesh)
    H, Kh = q.shape[2], k.shape[2]

    def body(ql, kl, vl):
        if kv_whole:
            Hl, G = ql.shape[2], H // Kh
            if Hl % G and G % Hl:
                raise ValueError(f"flash: {Hl} local query heads do not "
                                 f"tile the kv groups of {G}")
            h0 = coordinate(mesh, hdims) * Hl
            lo, hi = h0 // G, (h0 + Hl - 1) // G + 1
            kl, vl = kl[:, :, lo:hi], vl[:, :, lo:hi]
        return attend(ql, kl, vl, window, causal)

    gk = kp if not kv_whole else tuple(
        Partial() if i in hdims else p for i, p in enumerate(kp))
    return local_map(body, [qp], [qp, kp, kp], mesh, [qp, gk, gk])(q, k, v)


# ---------------------------------------------------------------------------
# Mamba-2 SSD
# ---------------------------------------------------------------------------
def _kernel_layout(x, P):
    """x (Bt, L, H, P) as the SSD kernel takes it: (H, P) contiguous."""
    return x if x.stride(3) == 1 and x.stride(2) == P else x.contiguous()


def ssd(scan, xh, dtf, A, Bm, Cm):
    """``scan(x, dt, A, B, C) -> (y, state)`` (``ops.mamba2_ssd``) of
    DTensors on each rank's batch and heads; B and C whole."""
    mesh, rules = shd.active()
    xp = shd.placements_of(xh, ("batch", "seq", "ssm_heads", None))
    dp = shd.placements_of(dtf, ("batch", "seq", "ssm_heads"))
    ap = shd.placements_of(A, ("ssm_heads",))
    bp = shd.placements_of(Bm, ("batch", "seq", None))
    hp = shd.placements_of(xh, ("batch", "ssm_heads", None, None))
    xh, dtf, A = _to(xh, mesh, xp), _to(dtf, mesh, dp), _to(A, mesh, ap)
    Bm, Cm = _to(Bm, mesh, bp), _to(Cm, mesh, bp)
    P = xh.shape[3]

    def body(x, dt, a, b, c):
        return scan(_kernel_layout(x, P), dt.contiguous(), a.contiguous(),
                    b, c)

    hdims = split_dims(xp, 2, mesh)
    gb = tuple(Partial() if i in hdims else p for i, p in enumerate(bp))
    return local_map(body, [xp, hp], [xp, dp, ap, bp, bp], mesh,
                     [xp, dp, ap, gb, gb])(xh, dtf, A, Bm, Cm)


# ---------------------------------------------------------------------------
# A recurrent state's update (decode)
# ---------------------------------------------------------------------------
def region(fn, args, in_axes, outs):
    """``fn(*args)`` on each rank's shard: each DTensor argument brought to
    the placements of its logical axes (None for a non-tensor), the
    results ``outs`` = [(shape, axes)] placed so.  The decode steps'
    state updates run here, batch on the batch axes and heads on
    ``model``, as plain torch on the local state."""
    mesh, rules = shd.active()
    ins, moved = [], []
    for a, ax in zip(args, in_axes):
        if shd.is_dtensor(a):
            pl = shd.placements_of(a, ax)
            ins.append(pl)
            moved.append(_to(a, mesh, pl))
        else:
            ins.append(None)
            moved.append(a)
    ops = [shd.logical_to_placements(ax, rules, mesh, shape)
           for shape, ax in outs]
    return local_map(fn, ops, ins, mesh)(*moved)


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------
def slstm(scan, xg, r_gates, H, dh):
    """``scan(xg, r_gates, H, dh)`` (the sequential recurrence) as one
    batch-parallel region: xg (B,S,4d) on the batch axes, the recurrent
    weights whole on every rank, their gradient a partial sum over the
    batch axes until the boundary reduces it."""
    mesh, rules = shd.active()
    gp = shd.placements_of(xg, ("batch", "seq", None))
    rp = (Replicate(),) * mesh.ndim
    bdims = split_dims(gp, 0, mesh)
    rg = tuple(Partial() if i in bdims else Replicate()
               for i in range(mesh.ndim))
    sp = shd.logical_to_placements(("batch", None, None), rules, mesh,
                                   (xg.shape[0], H, dh))
    hp = shd.logical_to_placements((None, "batch", None, None), rules, mesh,
                                   (xg.shape[1], xg.shape[0], H, dh))
    xg, r_gates = _to(xg, mesh, gp), _to(r_gates, mesh, rp)

    def body(a, r):
        st, hs = scan(a, r, H, dh)
        return (*st, hs)

    *st, hs = local_map(body, [sp] * 4 + [hp], [gp, rp], mesh, [gp, rg])(
        xg, r_gates)
    return tuple(st), hs


# ---------------------------------------------------------------------------
# The label log-likelihood over a vocab-split logits chunk
# ---------------------------------------------------------------------------
def label_nll(nll, logits, labels):
    """``nll(logits, labels)`` (logZ minus the label's logit, fp32) of a
    (B,S,V) DTensor.  Where the vocab splits over ranks, logZ is a max-
    shifted log of summed exponentials and the label's logit the sum
    against a one-hot of the rank's vocab slice (the reference's form),
    each reduced over the split by DTensor; else ``nll`` itself on each
    rank's rows."""
    mesh, rules = shd.active()
    lp = shd.placements_of(logits, ("batch", "seq", "vocab"))
    bp = tuple(p if not (p.is_shard() and p.dim == 2) else
                        Replicate() for p in lp)
    logits = _to(logits, mesh, lp)
    labels = _to(labels, mesh, shd.placements_of(labels, ("batch", "seq")))
    vdims = split_dims(lp, 2, mesh)
    if not vdims:
        return local_map(nll, [bp], [lp, labels.placements], mesh)(
            logits, labels)
    V = logits.shape[-1]

    def one_hot(lb):
        Vl = V // _span(mesh, vdims)
        v0 = coordinate(mesh, vdims) * Vl
        cols = torch.arange(v0, v0 + Vl, device=lb.device)
        return (lb.long()[..., None] == cols).float()

    oh = local_map(one_hot, [lp], [labels.placements], mesh)(labels)
    logits = logits.float()
    m = logits.detach().amax(-1, keepdim=True)
    lz = torch.log(torch.exp(logits - m).sum(-1)) + m[..., 0]
    return lz - (logits * oh).sum(-1)


def slstm_step(cell, r_gates, xg, state, dh):
    """``cell(r_gates, xg, state, H, dh)`` (one sLSTM step) on each rank's
    batch and heads, as the state (B, H, dh) is placed: the gate
    pre-activations xg (B, 4d) and the recurrent weights (H, dh, 4 dh)
    split as its heads (each head's 4 dh columns are contiguous)."""
    mesh, _ = shd.active()
    sp = tuple(state[0].placements)
    xp = tuple(Shard(p.dim) if p.is_shard() and p.dim < 2 else Replicate()
               for p in sp)
    rp = tuple(Shard(0) if p.is_shard() and p.dim == 1 else Replicate()
               for p in sp)
    xg, r_gates = _to(xg, mesh, xp), _to(r_gates, mesh, rp)

    def body(r, g, c, n, m, h):
        return cell(r, g, (c, n, m, h), c.shape[1], dh)

    return local_map(body, [sp] * 4, [rp, xp] + [sp] * 4, mesh)(
        r_gates, xg, *state)


# ---------------------------------------------------------------------------
# Decode against a cache
# ---------------------------------------------------------------------------
def cache_decode(attend, cache, names, axes, q_args, q_axes, slot,
                 out_axes):
    """One decode step's cache region on each rank's cache shard.

    ``cache`` holds DTensors; ``names`` the keys of it the region reads and
    writes, ``axes`` their logical axes.  ``q_args`` are the step's DTensor
    inputs (query and new rows) with their logical axes ``q_axes``; their
    batch goes as the cache's, and their head axis splits on ``model`` only
    where the cache's kv heads do.  ``attend(q_args, cache_locals,
    slot_local, t0, softmax, reduce_ctx)`` is the unsharded step's body on
    local tensors: it writes the new rows at ``slot_local`` (None where
    this rank's time range does not hold ``slot``) and calls
    ``softmax(s)`` and ``reduce_ctx(ctx)``, which reduce over the split
    time axis.  Returns its output, a DTensor of ``out_axes``."""
    mesh, rules = shd.active()
    cps = [shd.placements_of(cache[n], a) for n, a in zip(names, axes)]
    for n, pl in zip(names, cps):
        if tuple(cache[n].placements) != tuple(pl):
            raise ValueError(f"decode: cache {n!r} is placed "
                             f"{cache[n].placements}, its rule {pl}")
    tdims = split_dims(cps[0], 1, mesh)
    kv_split = any(split_dims(pl, a.index("kv_heads"), mesh)
                   for pl, a in zip(cps, axes) if "kv_heads" in a)

    def as_cache(ax):
        return tuple("cache_batch" if a == "batch" else
                     None if a in ("heads", "kv_heads") and not kv_split
                     else a for a in ax)

    qps = [shd.placements_of(x, as_cache(a)) for x, a in zip(q_args, q_axes)]
    q_args = [_to(x, mesh, pl) for x, pl in zip(q_args, qps)]
    op = shd.logical_to_placements(as_cache(out_axes), rules, mesh)
    nq = len(q_args)

    def body(*locals_):
        ql, cl = list(locals_[:nq]), list(locals_[nq:])
        Tl = cl[0].shape[1]
        t0 = coordinate(mesh, tdims) * Tl if tdims else 0
        sl = slot - t0 if t0 <= slot < t0 + Tl else None
        if not tdims:
            return attend(ql, cl, sl, t0, lambda s: torch.softmax(s, dim=-1),
                          lambda c: c)

        def softmax(s):
            m = all_reduce(s.amax(-1, keepdim=True), "max", mesh, tdims)
            e = torch.exp(s - m)
            return e / all_reduce(e.sum(-1, keepdim=True), "sum", mesh,
                                  tdims)

        return attend(ql, cl, sl, t0, softmax,
                      lambda c: all_reduce(c, "sum", mesh, tdims))

    return local_map(body, [op], [*qps, *cps], mesh)(
        *q_args, *[cache[n] for n in names])
