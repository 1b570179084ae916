"""gemma3-1b [dense] — 5:1 local(512-window):global, GQA kv=1, 128k context.
[hf:google/gemma-3-1b-pt]"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "gemma3-1b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense",
        n_layers=26, d_model=1152, n_heads=4, n_kv_heads=1, head_dim=256,
        d_ff=6912, vocab_size=262144,
        attention="gqa", qkv_bias=False, rope_theta=1_000_000.0,
        sliding_window=512, local_global_pattern=(5, 1),
        norm="rmsnorm", act="gelu",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="dense",
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=1, head_dim=32,
        d_ff=256, vocab_size=512,
        attention="gqa", sliding_window=32, local_global_pattern=(1, 1),
        norm="rmsnorm", act="gelu", dtype="float32", remat=False,
    )
