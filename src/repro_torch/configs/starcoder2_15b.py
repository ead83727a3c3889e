"""starcoder2-15b [arXiv:2402.19173; hf] — GQA kv=4, RoPE, non-gated GELU."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-15b", family="dense", n_layers=40, d_model=6144,
    n_heads=48, n_kv_heads=4, d_ff=24576, vocab_size=49152,
    rope_theta=1e5, act="gelu", mlp_gated=False,
)


def smoke() -> ArchConfig:
    return CONFIG.replace(n_layers=2, d_model=96, n_heads=6, n_kv_heads=2,
                          d_ff=256, vocab_size=256, remat=False)
