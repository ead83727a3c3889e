"""Architecture config schema + registry.

Every assigned architecture gets one module in this package defining
``CONFIG`` (exact published numbers) and ``smoke()`` (a reduced config of the
same family for CPU tests). ``get(name)`` resolves either.

The port's copy of the reference's ``configs/base.py``, with a module for
every id of ``ARCH_IDS``.
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass, field
from typing import Tuple


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads

    # --- attention variant ---
    attn_kind: str = "gqa"  # gqa | mla
    rope_theta: float = 1e4
    sliding_window: int = 0  # 0 -> full attention
    local_global_pattern: int = 0  # e.g. 5 -> 5 local : 1 global (gemma3)
    rope_theta_global: float = 0.0  # gemma3 global layers

    # --- MLA (deepseek) ---
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0  # per-expert hidden
    first_dense_layers: int = 0
    router_aux_coef: float = 0.001
    mtp: bool = False  # deepseek-v3 multi-token prediction head
    capacity_factor: float = 1.25  # per-expert slots = load * cf (cf>=E exact)

    # --- SSM / hybrid ---
    block_kind: str = "attn"  # attn | mamba | xlstm
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_conv: int = 4
    attn_every: int = 0  # zamba2: shared attn block period
    slstm_every: int = 0  # xlstm: sLSTM block period

    # --- encoder/decoder, modality stubs ---
    is_encdec: bool = False
    encoder_layers: int = 0
    encoder_len: int = 1500  # whisper frame count after conv stub
    n_patches: int = 0  # internvl2 prepended patch embeddings

    # --- misc ---
    norm_eps: float = 1e-6
    act: str = "silu"
    mlp_gated: bool = True
    vit_dim: int = 0  # vlm patch-embedding dim (frontend stub output)
    norm_kind: str = "rms"
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    kv_cache_dtype: str = "bf16"  # "int8": quantized serving cache (2x HBM)
    expert_weights_dtype: str = "bf16"  # "int8": weight-only quant (serving)
    remat: bool = True
    # full remat by default: inside scan-over-layers only the (B,S,d) carry
    # is saved; "dots_with_no_batch_dims_saveable" keeps every projection
    # output alive across 40-60 layers (tens of GiB/device at 4k x 256).
    remat_policy: str = "nothing_saveable"
    superblock: int = 1  # layers per scan step (heterogeneous patterns)
    notes: str = ""

    @property
    def dh(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def n_superblocks(self) -> int:
        core = self.n_layers - self.first_dense_layers
        assert core % self.superblock == 0, (self.name, core, self.superblock)
        return core // self.superblock

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Input shapes (assigned): every LM-family arch gets the same 4 shape specs.
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

ARCH_IDS = [
    "zamba2-2.7b",
    "codeqwen1.5-7b",
    "gemma3-12b",
    "starcoder2-15b",
    "tinyllama-1.1b",
    "deepseek-v2-236b",
    "deepseek-v3-671b",
    "internvl2-26b",
    "whisper-base",
    "xlstm-1.3b",
]


# the archs the port serves: every one
PORTED = ARCH_IDS


def _module(name: str):
    return importlib.import_module(f"repro_torch.configs.{name.replace('-', '_').replace('.', '_')}")


def get(name: str) -> ArchConfig:
    return _module(name).CONFIG


def smoke(name: str) -> ArchConfig:
    return _module(name).smoke()


def supports_shape(cfg: ArchConfig, shape: str) -> Tuple[bool, str]:
    """Whether (arch, shape) is a live dry-run cell; else reason for skip."""
    if shape == "long_500k":
        sub_quadratic = cfg.block_kind in ("mamba", "xlstm") or (
            cfg.local_global_pattern > 0
        )
        if not sub_quadratic:
            return False, "pure full-attention arch: 500k decode is skipped per brief"
    return True, ""
