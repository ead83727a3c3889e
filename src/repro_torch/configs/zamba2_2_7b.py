"""zamba2-2.7b [arXiv:2411.15242; hf] — Mamba2 backbone + weight-tied shared
attention block applied every 6 mamba layers (9 applications over 54 layers).

d_ff=10240 is the shared block's MLP. ssm: expand 2 (d_inner 5120),
headdim 64 (80 ssm heads), state 64, conv 4. The per-application LoRA on the
shared block from the paper is omitted (DESIGN.md §7).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b", family="hybrid", n_layers=54, d_model=2560,
    n_heads=32, n_kv_heads=32, d_ff=10240, vocab_size=32000,
    rope_theta=1e4, block_kind="mamba", ssm_state=64, ssm_expand=2,
    ssm_headdim=64, ssm_conv=4, attn_every=6, superblock=6,
)


def smoke() -> ArchConfig:
    return CONFIG.replace(n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
                          d_ff=128, vocab_size=256, ssm_state=16,
                          ssm_headdim=16, attn_every=2, superblock=2,
                          remat=False)
