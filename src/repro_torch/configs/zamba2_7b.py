"""zamba2-7b [hybrid] — Mamba-2 trunk + ONE shared attention block applied
every 6 mamba layers (weights shared across applications). [arXiv:2411.15242]"""
from repro_torch.configs.base import ModelConfig, SSMConfig

ARCH_ID = "zamba2-7b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="hybrid",
        n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32, head_dim=112,
        d_ff=14336, vocab_size=32000,
        attention="gqa", qkv_bias=False, rope_theta=10_000.0,
        ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64,
                      n_groups=1, chunk_size=256),
        shared_attn_every=6,
        norm="rmsnorm", act="silu",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="hybrid",
        n_layers=4, d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
        d_ff=256, vocab_size=512,
        attention="gqa",
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=32,
                      n_groups=1, chunk_size=32),
        shared_attn_every=2,
        norm="rmsnorm", act="silu", dtype="float32", remat=False,
    )
