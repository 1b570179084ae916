"""whisper-base [audio] — encoder-decoder; mel/conv frontend STUBBED to frame
embeddings (1500, d_model) supplied by input_specs. [arXiv:2212.04356]"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "whisper-base"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="audio",
        n_layers=6, d_model=512, n_heads=8, n_kv_heads=8, head_dim=64,
        d_ff=2048, vocab_size=51865,
        attention="gqa", qkv_bias=True, rope_theta=10_000.0,
        is_encoder_decoder=True, n_encoder_layers=6, encoder_seq=1500,
        norm="layernorm", act="gelu",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="audio",
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
        d_ff=256, vocab_size=512,
        attention="gqa", qkv_bias=True,
        is_encoder_decoder=True, n_encoder_layers=2, encoder_seq=64,
        norm="layernorm", act="gelu", dtype="float32", remat=False,
    )
