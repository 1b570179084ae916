"""qwen2-vl-72b [vlm] — M-RoPE (temporal/height/width rope sections), dynamic
resolution. Vision encoder is a STUB: input_specs provides precomputed patch
embeddings merged at the head of the sequence. [arXiv:2409.12191]"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "qwen2-vl-72b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="vlm",
        n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
        d_ff=29568, vocab_size=152064,
        attention="gqa", qkv_bias=True, rope_theta=1_000_000.0,
        mrope_sections=(16, 24, 24),   # halves of head_dim: 16+24+24 = 64
        n_vision_tokens=256,
        norm="rmsnorm", act="silu",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="vlm",
        n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, head_dim=64,
        d_ff=512, vocab_size=512,
        attention="gqa", qkv_bias=True,
        mrope_sections=(8, 12, 12),
        n_vision_tokens=16,
        norm="rmsnorm", act="silu", dtype="float32", remat=False,
    )
