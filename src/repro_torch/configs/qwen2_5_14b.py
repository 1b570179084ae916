"""qwen2.5-14b [dense] — GQA kv=8, QKV bias. [hf:Qwen/Qwen2.5-0.5B family]"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "qwen2.5-14b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense",
        n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
        d_ff=13824, vocab_size=152064,
        attention="gqa", qkv_bias=True, rope_theta=1_000_000.0,
        norm="rmsnorm", act="silu",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="dense",
        n_layers=2, d_model=256, n_heads=8, n_kv_heads=2, head_dim=32,
        d_ff=512, vocab_size=512,
        attention="gqa", qkv_bias=True, rope_theta=1_000_000.0,
        norm="rmsnorm", act="silu", dtype="float32", remat=False,
    )
