"""xlstm-1.3b [arXiv:2405.04517; unverified] — mLSTM + sLSTM blocks.

Superblock of 6 = 5 mLSTM (matrix memory, chunkwise-parallel) + 1 sLSTM
(scalar memory, sequential scan). d_ff=0 per the brief: projections live
inside the blocks (mLSTM up-factor 2; sLSTM carries a 4/3 gated FFN).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-1.3b", family="ssm", n_layers=48, d_model=2048,
    n_heads=4, n_kv_heads=4, d_ff=0, vocab_size=50304,
    block_kind="xlstm", slstm_every=6, superblock=6,
)


def smoke() -> ArchConfig:
    return CONFIG.replace(n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
                          vocab_size=256, slstm_every=2, superblock=2,
                          remat=False)
