from repro_torch.configs.base import (
    ARCH_FAMILIES, LONG_CONTEXT_ARCHS, MULTI_POD, SHAPES, SINGLE_POD,
    MeshConfig, MLAConfig, ModelConfig, MoEConfig, OptimizerConfig,
    PhaseConfig, ScheduleConfig, ShapeConfig, SSMConfig, SWAConfig,
    SWAPConfig, TrainConfig, replace, shape_applicable,
)
from repro_torch.configs.registry import (
    ASSIGNED_ARCHS, all_configs, get_config, get_smoke_config, list_archs,
)
