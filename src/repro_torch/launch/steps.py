"""The train step: microbatched gradient accumulation, global-norm
clipping, the optimizer update and the reference's metrics.

The port of ``make_train_step`` and its microbatch policy from the
reference's ``launch/steps.py``, on one device (the reference's sharded
step fails, ROADMAP R7, so the port is held against its single-device
path).  The serve steps are ``models.model.prefill`` / ``serve_step``
themselves (PyTorch runs eagerly, there is nothing to lower), and
``step_fn_for`` feeds the reference's dry-run, which ports with the mesh
tooling (ROADMAP Queue 1 item 11).
"""
from __future__ import annotations

import torch

from repro_torch.models import model as mdl
from repro_torch.optim import Optimizer, param_count
from repro_torch.optim.optimizers import named_leaves


# the activation target of the microbatch policy, the reference's number
# (no TPU memory size enters it)
ACT_TARGET_BYTES = 3.0e9


def auto_microbatches(cfg, B: int, S: int) -> int:
    """Smallest power-of-2 microbatch count s.t. the carried activation
    footprint (B_micro * S * d per layer, bf16, x1.5) fits
    ``ACT_TARGET_BYTES``, and at most B.  The reference's policy on one
    device (its ``batch_shards`` = ``seq_shards`` = 1; the mesh that would
    set them ports with ROADMAP Queue 1 item 11)."""
    n_micro = 1
    while n_micro < max(B, 1):
        act = cfg.n_layers * max(B // n_micro, 1) * S * cfg.d_model \
            * 2 * 1.5
        if act <= ACT_TARGET_BYTES:
            break
        n_micro *= 2
    return n_micro


def grad_accum_dtype(cfg):
    """fp32 accumulation when it fits; bf16 for 100B+ giants (memory)."""
    return torch.bfloat16 if param_count(cfg) >= 100e9 else torch.float32


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
        B = next(iter(batch.values())).shape[0]
        if B % n_micro:
            raise ValueError(f"batch {B} does not split into {n_micro} "
                             "microbatches")
        b = B // n_micro
        acc = None
        if n_micro > 1 and any(p.dtype != accum_dt for p in leaves.values()):
            acc = {k: torch.zeros(p.shape, dtype=accum_dt, device=p.device)
                   for k, p in leaves.items()}
        loss, ms = 0.0, []
        for i in range(n_micro):
            micro = {k: v[i * b:(i + 1) * b] for k, v in batch.items()}
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
        metrics = {k: torch.stack([torch.as_tensor(m[k]) for m in ms])
                   .mean(0) for k in ms[0]}
        params, opt_state, om = opt.update(grads, opt_state, params, step)
        del grads, acc
        for p in leaves.values():
            p.grad = None
        return params, opt_state, dict(metrics, loss=loss, **om)

    return train_step
