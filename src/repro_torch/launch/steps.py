"""Step functions: the train step (microbatched gradient accumulation,
global-norm clipping, the optimizer update and the reference's metrics)
and ``step_fn_for``, which gives a cell's step (train, prefill or greedy
serve; the reference's ``make_prefill_step`` and ``make_serve_step`` are
its two inner functions): the steps the dry run traces.

The port of the reference's ``launch/steps.py``.  PyTorch runs eagerly, so
a step is a function that is called, not lowered.  Under a mesh
(``sharding.use_rules``) the same functions take DTensor parameters,
state and inputs: each rank's microbatches are its own rows of the batch,
and the global norm is reduced over every shard before the clip.
"""
from __future__ import annotations

import torch

from repro_torch.models import model as mdl
from repro_torch.optim import Optimizer, param_count
from repro_torch.optim.optimizers import named_leaves
from repro_torch.sharding import full_tensor, is_dtensor


# the activation target of the microbatch policy, the reference's number
# (no TPU memory size enters it)
ACT_TARGET_BYTES = 3.0e9


def auto_microbatches(cfg, B: int, S: int, batch_shards: int = 1,
                      seq_shards: int = 1) -> int:
    """Smallest power-of-2 microbatch count s.t. the per-device carried
    activation footprint (B_local * S * d per layer, bf16, x1.5) fits
    ``ACT_TARGET_BYTES``.

    Capped so each microbatch still divides over the batch-sharded axis.
    ``seq_shards`` > 1 models sequence-parallel carries (fsdp_sp rules)."""
    n_micro, cap = 1, max(B // batch_shards, 1)
    while n_micro < cap:
        b_local = max(B // batch_shards // n_micro, 1)
        act = cfg.n_layers * b_local * (S // seq_shards) \
            * cfg.d_model * 2 * 1.5
        if act <= ACT_TARGET_BYTES:
            break
        n_micro *= 2
    return n_micro


def grad_accum_dtype(cfg):
    """fp32 accumulation when it fits; bf16 for 100B+ giants (memory)."""
    return torch.bfloat16 if param_count(cfg) >= 100e9 else torch.float32


def _micro(v, i: int, n: int):
    """Microbatch ``i`` of ``n`` of a batch tensor: rows i*b .. (i+1)*b, b
    = B / n; of a DTensor, those rows of each rank's shard."""
    if not is_dtensor(v):
        b = v.shape[0] // n
        return v[i * b:(i + 1) * b]
    from torch.distributed.tensor import DTensor
    loc = v.to_local()
    b = loc.shape[0] // n
    return DTensor.from_local(loc[i * b:(i + 1) * b], v.device_mesh,
                              v.placements, run_check=False)


def make_train_step(cfg, opt: Optimizer, *, n_micro: int = 1):
    """``train_step(params, opt_state, batch, step) -> (params, opt_state,
    metrics)``: ``params`` the model (its trainable parameters), ``batch``
    a dict of tensors on its device, split on dim 0 into ``n_micro``
    microbatches whose gradients are summed in ``grad_accum_dtype`` and
    averaged, then clipped and applied by ``opt`` (in place).  Metrics:
    ``loss``, ``ce``, ``aux`` (``mtp``), averaged over the microbatches,
    and the optimizer's ``grad_norm`` and ``lr``, as 0-d tensors.

    Gradients accumulate in the parameters' ``.grad`` where their dtype is
    the accumulation dtype (one set of gradients on the device), else in a
    separate buffer; they are dropped after the update."""
    accum_dt = grad_accum_dtype(cfg)

    def train_step(params, opt_state, batch, step):
        leaves = named_leaves(params)
        for p in leaves.values():
            p.grad = None
        first = next(iter(batch.values()))
        B = (first.to_local() if is_dtensor(first) else first).shape[0]
        if B % n_micro:
            raise ValueError(f"batch {B} does not split into {n_micro} "
                             "microbatches")
        acc = None
        if n_micro > 1 and any(p.dtype != accum_dt for p in leaves.values()):
            acc = {k: torch.zeros_like(p, dtype=accum_dt,
                                       memory_format=torch.contiguous_format)
                   for k, p in leaves.items()}
        loss, ms = 0.0, []
        for i in range(n_micro):
            micro = {k: _micro(v, i, n_micro) for k, v in batch.items()}
            l, m = mdl.loss_fn(params, cfg, micro)
            l.backward()
            if acc is not None:
                for k, p in leaves.items():
                    acc[k] += p.grad.to(accum_dt)
                    p.grad = None
            loss = loss + l.detach()
            ms.append({k: v.detach() for k, v in m.items()})
        grads = acc if acc is not None else \
            {k: p.grad for k, p in leaves.items()}
        if n_micro > 1:
            for g in grads.values():
                g.div_(n_micro)
            loss = loss / n_micro
        metrics = {k: torch.stack([torch.as_tensor(full_tensor(m[k]))
                                   for m in ms]).mean(0) for k in ms[0]}
        params, opt_state, om = opt.update(grads, opt_state, params, step)
        del grads, acc
        for p in leaves.values():
            p.grad = None
        return params, opt_state, dict(metrics, loss=full_tensor(loss), **om)

    return train_step


# ---------------------------------------------------------------------------
# Serve steps
# ---------------------------------------------------------------------------
def step_fn_for(cfg, shape, opt: Optimizer | None, batch_shards: int,
                seq_shards: int = 1):
    """(callable, donated argument positions, n_micro) for the step
    ``shape.kind`` implies: the train step, the prefill
    (``model.prefill``) or the greedy serve step (``model.serve_step``);
    the donated positions are the reference's (the port updates
    parameters, state and caches in place)."""
    if shape.kind == "train":
        n_micro = auto_microbatches(cfg, shape.global_batch, shape.seq_len,
                                    batch_shards, seq_shards=seq_shards)
        return make_train_step(cfg, opt, n_micro=n_micro), (0, 1), n_micro
    if shape.kind == "prefill":
        def prefill_step(params, batch):
            return mdl.prefill(params, cfg, batch)
        return prefill_step, (), 1
    if shape.kind == "decode":
        def serve_step(params, token, pos, cache):
            return mdl.serve_step(params, cfg, token, pos, cache)
        return serve_step, (3,), 1
    raise ValueError(shape.kind)
