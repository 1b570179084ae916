from repro_torch.serve.compiled import (CompiledServingEngine, DecodeState,
                                        default_buckets)
from repro_torch.serve.engine import Request, ServingEngine
from repro_torch.serve.publish import PublishFollower, WeightPublisher

__all__ = ["CompiledServingEngine", "DecodeState", "PublishFollower",
           "Request", "ServingEngine", "WeightPublisher", "default_buckets"]
