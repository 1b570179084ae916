"""mamba2-2.7b [ssm] — SSD (state-space duality), attention-free. [arXiv:2405.21060]"""
from repro_torch.configs.base import ModelConfig, SSMConfig

ARCH_ID = "mamba2-2.7b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="ssm",
        n_layers=64, d_model=2560, n_heads=0, n_kv_heads=0, head_dim=64,
        d_ff=0, vocab_size=50280,
        attention="none",
        ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64,
                      n_groups=1, chunk_size=256),
        norm="rmsnorm", act="silu",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="ssm",
        n_layers=2, d_model=256, n_heads=0, n_kv_heads=0, head_dim=32,
        d_ff=0, vocab_size=512,
        attention="none",
        ssm=SSMConfig(d_state=32, d_conv=4, expand=2, head_dim=32,
                      n_groups=1, chunk_size=64),
        norm="rmsnorm", act="silu", dtype="float32", remat=False,
    )
