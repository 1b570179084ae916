"""internlm2-1.8b [dense] — GQA kv=8. [arXiv:2403.17297]"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "internlm2-1.8b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense",
        n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8, head_dim=128,
        d_ff=8192, vocab_size=92544,
        attention="gqa", qkv_bias=False, rope_theta=1_000_000.0,
        norm="rmsnorm", act="silu",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="dense",
        n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, head_dim=64,
        d_ff=512, vocab_size=512,
        attention="gqa", rope_theta=1_000_000.0,
        norm="rmsnorm", act="silu", dtype="float32", remat=False,
    )
