"""Cache engine factory (counterpart of vattention_tpu/worker/cache_engine/__init__.py).

Routes backends as the JAX factory does: the contiguous-arena names
(``AttentionBackend.is_vATTN``, the POD names among them) and ``no_op``
get the vattn arena, every other name the paged pool.
"""

from __future__ import annotations

import torch

from vattention_tpu_torch.config import SystemConfig
from vattention_tpu_torch.model_executor.attention import AttentionBackend
from vattention_tpu_torch.worker.cache_engine.base_cache_engine import (
    BaseCacheEngine,
)
from vattention_tpu_torch.worker.cache_engine.paged_cache_engine import (
    PagedCacheEngine,
)
from vattention_tpu_torch.worker.cache_engine.vattn_cache_engine import (
    VAttnCacheEngine,
)


def get_cache_engine(config: SystemConfig,
                     device: torch.device) -> BaseCacheEngine:
    backend = config.model_config.attention_backend
    if AttentionBackend.is_vATTN(backend) or AttentionBackend.is_no_op(backend):
        return VAttnCacheEngine(config, device)
    return PagedCacheEngine(config, device)
