from repro_torch.kernels.swa_avg.ops import (  # noqa: F401
    running_average, running_average_tree,
)
