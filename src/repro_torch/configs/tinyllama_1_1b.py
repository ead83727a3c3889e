"""tinyllama-1.1b [arXiv:2401.02385; hf] — llama2-arch small."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="tinyllama-1.1b", family="dense", n_layers=22, d_model=2048,
    n_heads=32, n_kv_heads=4, d_ff=5632, vocab_size=32000,
    rope_theta=1e4,
)


def smoke() -> ArchConfig:
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                          d_ff=160, vocab_size=256, remat=False)
