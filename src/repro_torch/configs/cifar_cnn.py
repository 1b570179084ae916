"""Paper-faithful CIFAR-analog model: small CNN with BatchNorm (ResNet9-style
channel progression, davidcpage/cifar10-fast inspired). Used by the SWAP
reproduction benchmarks (Tables 1/2/4, Figures 1-4) on synthetic image data;
exercises phase-3 batch-norm statistic recomputation, which the transformer
archs don't need."""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "cifar-cnn"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="cnn",
        n_layers=0, d_model=0, n_heads=0, n_kv_heads=0, d_ff=0, vocab_size=0,
        attention="none", norm="layernorm",
        cnn_channels=(64, 128, 256, 256), n_classes=10, image_size=32,
        dtype="float32", remat=False,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="cnn",
        n_layers=0, d_model=0, n_heads=0, n_kv_heads=0, d_ff=0, vocab_size=0,
        attention="none", norm="layernorm",
        cnn_channels=(16, 32), n_classes=10, image_size=16,
        dtype="float32", remat=False,
    )
