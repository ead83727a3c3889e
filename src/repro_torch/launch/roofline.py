"""Roofline terms of a dry-run cell, on NVIDIA H100 constants.

The port of the reference's ``launch/roofline.py``:

    compute term    = per-device dot FLOPs / peak bf16 FLOP/s
    memory term     = per-device matmul-boundary bytes / HBM bandwidth
    collective term = the larger of the per-device collective bytes on
                      ``model`` over NVLink and those on ``data`` / ``pod``
                      over InfiniBand (``collective_link`` names which)

All inputs are per-device (the dry run counts on each rank's local
shards).  MODEL_FLOPS is the closed-form useful compute (6*N*D train,
2*N*D forward); its ratio against the counted FLOPs exposes remat and
dispatch waste.  ``active_param_count``, ``attn_flops`` and
``model_flops`` are the reference's; the constants are the H100's
(``launch/mesh.py``), none of the TPU's.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.launch.mesh import HBM_BW, IB_BW, NVLINK_BW, PEAK_FLOPS_BF16
from repro_torch.optim.optimizers import param_count


def active_param_count(cfg) -> float:
    """Params touched per token (MoE: routed top-k only + shared)."""
    if cfg.family != "moe":
        return param_count(cfg)
    full = param_count(cfg)
    per_exp = 3 * cfg.d_model * cfg.moe_d_ff
    moe_layers = cfg.n_layers - cfg.first_dense_layers
    routed_all = moe_layers * cfg.n_experts * per_exp
    routed_active = moe_layers * cfg.experts_per_token * per_exp
    return full - routed_all + routed_active


def attn_flops(cfg, shape) -> float:
    """Closed-form useful attention FLOPs (score + context matmuls)."""
    B, S = shape.global_batch, shape.seq_len
    fam = cfg.family
    if fam == "gemma3":
        n_local = cfg.n_layers * cfg.local_global_pattern // (
            cfg.local_global_pattern + 1)
        layers = [(n_local, min(cfg.sliding_window, S)),
                  (cfg.n_layers - n_local, S)]
    elif fam == "hybrid":
        layers = [(cfg.n_layers // cfg.superblock, S)]  # shared attn blocks
    elif fam == "ssm":
        return 0.0  # mLSTM/sLSTM: linear recurrence, no S^2 term
    elif fam == "audio":
        # decoder self (causal) + decoder cross (full memory) + encoder
        # self (bidirectional) — for a 512-dim model these dominate params
        H, dh = cfg.n_heads, cfg.dh
        per = 2.0 * H * 2 * dh                     # score + context, per pair
        Se = cfg.encoder_len
        if shape.kind == "decode":
            pairs = B * cfg.n_layers * (S + Se)    # one query token
        else:
            pairs = B * cfg.n_layers * (S * S / 2 + S * Se) \
                + B * cfg.encoder_layers * Se * Se
        total = per * pairs
        if shape.kind == "train":
            total *= 3.0
        return total
    else:
        layers = [(cfg.n_layers, S)]
    H = cfg.n_heads
    if cfg.attn_kind == "mla":
        if shape.kind == "decode":
            # absorbed decode: scores vs (kvr + rope), context gather kvr
            dq = cfg.kv_lora_rank + cfg.qk_rope_head_dim
            dv = cfg.kv_lora_rank
        else:
            dq = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
            dv = cfg.v_head_dim
    else:
        dq = dv = cfg.dh
    total = 0.0
    for L, ctx in layers:
        if shape.kind == "decode":
            total += 2.0 * B * L * H * ctx * (dq + dv)
        else:
            avg = ctx / 2 if ctx >= S else ctx  # causal half vs window band
            total += 2.0 * B * S * L * H * avg * (dq + dv)
    if shape.kind == "train":
        total *= 3.0  # fwd + bwd
    return total


def model_flops(cfg, shape) -> float:
    n = active_param_count(cfg)
    attn = attn_flops(cfg, shape)
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len + attn
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len + attn
    # decode: one token per sequence through the whole model
    return 2.0 * n * shape.global_batch + attn


@dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    collective_nvlink_s: float
    collective_ib_s: float
    collective_link: str
    dominant: str
    model_flops: float
    counted_flops_global: float
    useful_ratio: float

    def to_dict(self):
        return self.__dict__.copy()


def derive(cfg, shape, *, dot_flops_dev: float, traffic_bytes_dev: float,
           nvlink_bytes_dev: float, ib_bytes_dev: float,
           n_chips: int) -> Roofline:
    """``traffic_bytes_dev`` is the matmul-boundary bytes (the operands and
    results of the dots and the kernels' operators); ``nvlink_bytes_dev``
    the collective bytes on the ``model`` axis, ``ib_bytes_dev`` those on
    ``data`` and ``pod``."""
    c = dot_flops_dev / PEAK_FLOPS_BF16
    m = traffic_bytes_dev / HBM_BW
    kn = nvlink_bytes_dev / NVLINK_BW
    ki = ib_bytes_dev / IB_BW
    k, link = max(("nvlink", kn), ("infiniband", ki), key=lambda t: t[1])[::-1]
    dom = max(("compute", c), ("memory", m), ("collective", k),
              key=lambda t: t[1])[0]
    mf = model_flops(cfg, shape)
    counted = dot_flops_dev * n_chips
    return Roofline(
        compute_s=c, memory_s=m, collective_s=k, collective_nvlink_s=kn,
        collective_ib_s=ki, collective_link=link, dominant=dom,
        model_flops=mf, counted_flops_global=counted,
        useful_ratio=mf / counted if counted else 0.0,
    )
