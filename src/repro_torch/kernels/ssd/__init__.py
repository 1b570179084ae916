from repro_torch.kernels.ssd.ops import (  # noqa: F401
    SSDIntraChunk, ssd_decode, ssd_scan,
)
