"""deepseek-v3-671b [arXiv:2412.19437; hf] — MLA, 1 shared + 256 routed
top-8, first 3 layers dense (d_ff 18432; per-expert 2048), MTP depth-1."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v3-671b", family="moe", n_layers=61, d_model=7168,
    n_heads=128, n_kv_heads=128, d_ff=18432, vocab_size=129280,
    attn_kind="mla", q_lora_rank=1536, kv_lora_rank=512,
    qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
    n_experts=256, n_shared_experts=1, experts_per_token=8,
    moe_d_ff=2048, first_dense_layers=3, mtp=True, rope_theta=1e4,
)


def smoke() -> ArchConfig:
    return CONFIG.replace(n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
                          d_ff=128, vocab_size=256, q_lora_rank=32,
                          kv_lora_rank=32, qk_nope_head_dim=16,
                          qk_rope_head_dim=8, v_head_dim=16, n_experts=8,
                          experts_per_token=2, moe_d_ff=64,
                          first_dense_layers=1, remat=False,
                          capacity_factor=16.0)  # dropless at smoke scale
