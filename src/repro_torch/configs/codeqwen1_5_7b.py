"""codeqwen1.5-7b [hf:Qwen/CodeQwen1.5-7B] — qwen1.5-arch, MHA (kv=H)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="codeqwen1.5-7b", family="dense", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=32, d_ff=13440, vocab_size=92416,
    rope_theta=1e6,
)


def smoke() -> ArchConfig:
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                          d_ff=192, vocab_size=256, remat=False)
