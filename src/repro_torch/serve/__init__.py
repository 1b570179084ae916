from repro_torch.serve.compiled import (CompiledServingEngine, DecodeState,
                                        default_buckets)
from repro_torch.serve.engine import Request, ServingEngine

__all__ = ["CompiledServingEngine", "DecodeState", "Request",
           "ServingEngine", "default_buckets"]
