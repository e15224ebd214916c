from vattention_tpu_torch.benchmark.request_generator.base import (
    Request, RequestGeneratorRegistry)

__all__ = ["Request", "RequestGeneratorRegistry"]
