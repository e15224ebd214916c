from vattention_tpu_torch.memory.allocator import (
    VAttentionAllocator,
    RelocationPlan,
    Relocation,
)

__all__ = ["VAttentionAllocator", "RelocationPlan", "Relocation"]
