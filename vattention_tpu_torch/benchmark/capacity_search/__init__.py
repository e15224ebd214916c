from vattention_tpu_torch.benchmark.capacity_search.capacity_search import (
    CapacitySearch,
)

__all__ = ["CapacitySearch"]
