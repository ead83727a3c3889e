"""gemma3-12b [hf:google/gemma-3-*-pt; unverified] — 5 local : 1 global.

head_dim derived from the brief's d_model/n_heads = 240 (the HF release uses
256; the brief's numbers take precedence). Local layers: sliding window 1024,
theta 10k. Global layers: full attention, theta 1M.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-12b", family="gemma3", n_layers=48, d_model=3840,
    n_heads=16, n_kv_heads=8, d_ff=15360, vocab_size=262144,
    rope_theta=1e4, rope_theta_global=1e6,
    sliding_window=1024, local_global_pattern=5, superblock=6,
    act="gelu", tie_embeddings=True,
)


def smoke() -> ArchConfig:
    return CONFIG.replace(n_layers=6, d_model=64, n_heads=4, n_kv_heads=2,
                          d_ff=160, vocab_size=256, sliding_window=8,
                          remat=False)
