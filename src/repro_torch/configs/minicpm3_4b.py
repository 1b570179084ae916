"""minicpm3-4b [dense] — MLA (multi-head latent attention). [hf:openbmb/MiniCPM3-4B]"""
from repro_torch.configs.base import MLAConfig, ModelConfig

ARCH_ID = "minicpm3-4b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense",
        n_layers=62, d_model=2560, n_heads=40, n_kv_heads=40, head_dim=64,
        d_ff=6400, vocab_size=73448,
        attention="mla", rope_theta=10_000.0,
        mla=MLAConfig(q_lora_rank=768, kv_lora_rank=256,
                      qk_nope_head_dim=64, qk_rope_head_dim=32, v_head_dim=64),
        norm="rmsnorm", act="silu",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="dense",
        n_layers=2, d_model=256, n_heads=4, n_kv_heads=4, head_dim=32,
        d_ff=512, vocab_size=512,
        attention="mla",
        mla=MLAConfig(q_lora_rank=64, kv_lora_rank=32,
                      qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32),
        norm="rmsnorm", act="silu", dtype="float32", remat=False,
    )
