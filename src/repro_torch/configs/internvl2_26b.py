"""internvl2-26b [arXiv:2404.16821; hf] — InternViT frontend (STUB: 256
precomputed patch embeddings of dim 3200) + InternLM2-20B-class backbone."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-26b", family="vlm", n_layers=48, d_model=6144,
    n_heads=48, n_kv_heads=8, d_ff=16384, vocab_size=92553,
    rope_theta=1e6, n_patches=256, vit_dim=3200,
)


def smoke() -> ArchConfig:
    return CONFIG.replace(n_layers=2, d_model=96, n_heads=6, n_kv_heads=2,
                          d_ff=256, vocab_size=256, n_patches=8, vit_dim=32,
                          remat=False)
