"""Cache engine factory (counterpart of vattention_tpu/worker/cache_engine/__init__.py).

Only the fa_vattn arena is ported; the paged, POD and other backends are
ROADMAP Queue 1 items 9-11.
"""

from __future__ import annotations

import torch

from vattention_tpu_torch.config import SystemConfig
from vattention_tpu_torch.model_executor.attention import AttentionBackend
from vattention_tpu_torch.worker.cache_engine.base_cache_engine import (
    BaseCacheEngine,
)
from vattention_tpu_torch.worker.cache_engine.vattn_cache_engine import (
    VAttnCacheEngine,
)


def get_cache_engine(config: SystemConfig,
                     device: torch.device) -> BaseCacheEngine:
    backend = config.model_config.attention_backend
    if AttentionBackend.resolve(backend) is AttentionBackend.FA_VATTN:
        return VAttnCacheEngine(config, device)
    raise NotImplementedError(
        f"attention backend {backend!r} is not ported yet; only "
        "fa_vattn[_<page size>] is (ROADMAP Queue 1 items 9-11)")
