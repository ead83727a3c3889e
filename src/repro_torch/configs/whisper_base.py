"""whisper-base [arXiv:2212.04356; unverified] — enc-dec, conv frontend STUB
(input_specs supplies (B, 1500, 512) frame embeddings), sinusoid positions."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-base", family="audio", n_layers=6, d_model=512,
    n_heads=8, n_kv_heads=8, d_ff=2048, vocab_size=51865,
    rope_theta=0.0, act="gelu", mlp_gated=False, is_encdec=True,
    encoder_layers=6, encoder_len=1500, tie_embeddings=True,
)


def smoke() -> ArchConfig:
    return CONFIG.replace(n_layers=2, encoder_layers=2, d_model=64,
                          n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=256,
                          encoder_len=24, remat=False)
