"""qwen3-moe-235b-a22b [moe] — 94L, 128 experts top-8, GQA kv=4.
[hf:Qwen/Qwen3-30B-A3B family]"""
from repro_torch.configs.base import ModelConfig, MoEConfig

ARCH_ID = "qwen3-moe-235b-a22b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="moe",
        n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, head_dim=128,
        d_ff=1536, vocab_size=151936,
        attention="gqa", qkv_bias=False, rope_theta=1_000_000.0,
        moe=MoEConfig(n_experts=128, top_k=8, d_ff=1536, capacity_factor=1.25),
        norm="rmsnorm", act="silu",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="moe",
        n_layers=2, d_model=128, n_heads=8, n_kv_heads=2, head_dim=16,
        d_ff=64, vocab_size=512,
        attention="gqa",
        moe=MoEConfig(n_experts=4, top_k=2, d_ff=64, capacity_factor=1.5),
        norm="rmsnorm", act="silu", dtype="float32", remat=False,
    )
