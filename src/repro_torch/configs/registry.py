"""Architecture registry: ``get_config(arch_id)`` / ``get_smoke_config(arch_id)``."""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import ModelConfig

_MODULES = {
    "qwen2.5-14b": "repro_torch.configs.qwen2_5_14b",
    "internlm2-1.8b": "repro_torch.configs.internlm2_1_8b",
    "mamba2-2.7b": "repro_torch.configs.mamba2_2_7b",
    "gemma3-1b": "repro_torch.configs.gemma3_1b",
    "granite-moe-3b-a800m": "repro_torch.configs.granite_moe_3b",
    "qwen3-moe-235b-a22b": "repro_torch.configs.qwen3_moe_235b",
    "zamba2-7b": "repro_torch.configs.zamba2_7b",
    "minicpm3-4b": "repro_torch.configs.minicpm3_4b",
    "qwen2-vl-72b": "repro_torch.configs.qwen2_vl_72b",
    "whisper-base": "repro_torch.configs.whisper_base",
    "cifar-cnn": "repro_torch.configs.cifar_cnn",
    "deepseek-v2-lite": "repro_torch.configs.deepseek_v2_lite",
}

# The 10 assigned architectures (cifar-cnn is the paper-faithful extra;
# deepseek-v2-lite is a beyond-assignment MLA+MoE composition bonus).
_EXTRAS = ("cifar-cnn", "deepseek-v2-lite")
ASSIGNED_ARCHS: List[str] = [a for a in _MODULES if a not in _EXTRAS]
BONUS_ARCHS: List[str] = ["deepseek-v2-lite"]


def list_archs() -> List[str]:
    return list(_MODULES)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[arch_id]).config()


def get_smoke_config(arch_id: str) -> ModelConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[arch_id]).smoke_config()


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ASSIGNED_ARCHS}
