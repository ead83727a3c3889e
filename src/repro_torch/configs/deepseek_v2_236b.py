"""deepseek-v2-236b [arXiv:2405.04434; hf] — MLA kv_lora=512, 2 shared +
160 routed experts top-6, first layer dense (d_ff 12288; per-expert 1536)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v2-236b", family="moe", n_layers=60, d_model=5120,
    n_heads=128, n_kv_heads=128, d_ff=12288, vocab_size=102400,
    attn_kind="mla", q_lora_rank=1536, kv_lora_rank=512,
    qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
    n_experts=160, n_shared_experts=2, experts_per_token=6,
    moe_d_ff=1536, first_dense_layers=1, rope_theta=1e4,
)


def smoke() -> ArchConfig:
    return CONFIG.replace(n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
                          d_ff=128, vocab_size=256, q_lora_rank=32,
                          kv_lora_rank=32, qk_nope_head_dim=16,
                          qk_rope_head_dim=8, v_head_dim=16, n_experts=8,
                          experts_per_token=2, moe_d_ff=64,
                          first_dense_layers=1, remat=False,
                          capacity_factor=16.0)  # dropless at smoke scale
