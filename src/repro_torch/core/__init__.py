"""SWAP -- the paper's contribution: three-phase large-batch + parallel
weight-averaging training (controller, schedules, averaging, SWA baseline).
Twin of ``repro/core/__init__.py``."""
from repro_torch.core.adapters import CNNAdapter, LMAdapter  # noqa: F401
from repro_torch.core.averaging import (  # noqa: F401
    StreamingAverage, average_list, average_stacked, recompute_bn_stats,
)
from repro_torch.core.schedules import schedule_fn  # noqa: F401
from repro_torch.core.swa import SWA  # noqa: F401
from repro_torch.core.swap import SWAP, SGDRun  # noqa: F401
