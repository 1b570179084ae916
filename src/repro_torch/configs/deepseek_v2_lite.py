"""BONUS (beyond assignment): deepseek-v2-lite [moe+mla] — demonstrates the
framework composing MLA attention with MoE FFNs in one architecture
(27L d_model=2048, MLA kv_lora=512, 64 experts top-6 + 2 shared experts).
[arXiv:2405.04434]"""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

ARCH_ID = "deepseek-v2-lite"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="moe",
        n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
        d_ff=1408, vocab_size=102400,
        attention="mla", rope_theta=10_000.0,
        mla=MLAConfig(q_lora_rank=768, kv_lora_rank=512,
                      qk_nope_head_dim=128, qk_rope_head_dim=64,
                      v_head_dim=128),
        moe=MoEConfig(n_experts=64, top_k=6, d_ff=1408,
                      capacity_factor=1.25),
        norm="rmsnorm", act="silu",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="moe",
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
        d_ff=64, vocab_size=512,
        attention="mla",
        mla=MLAConfig(q_lora_rank=64, kv_lora_rank=32,
                      qk_nope_head_dim=32, qk_rope_head_dim=16,
                      v_head_dim=32),
        moe=MoEConfig(n_experts=4, top_k=2, d_ff=64, capacity_factor=1.5),
        norm="rmsnorm", act="silu", dtype="float32", remat=False,
    )
