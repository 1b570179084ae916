"""Build a model from a ModelConfig: twin of ``repro/models/registry.py``."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import Model


def build_model(cfg: ModelConfig) -> Model:
    if cfg.family == "cnn":
        raise ValueError(
            "cnn family uses repro_torch.models.cnn functional API, not Model")
    return Model(cfg)
