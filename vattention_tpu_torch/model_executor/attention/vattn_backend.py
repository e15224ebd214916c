"""vATTN attention backend: the port's kernels over the contiguous arena.

Counterpart of ``vattention_tpu/model_executor/attention/vattn_backend.py``
(``append_kv`` and ``attend``), for float32 and bfloat16 arenas.  K/V are
appended first (kernel A), then the prefill region attends through kernel
B and the decode slots through kernel C; all three read the arena through
host-resolved row tables at ``sub``-row granularity.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from vattention_tpu_torch.config import PREFILL_TOKEN_PAD
from vattention_tpu_torch.model_executor.step_inputs import StepInputs
from vattention_tpu_torch.ops.cache_append import kv_append
from vattention_tpu_torch.ops.flash_decode import decode_attention
from vattention_tpu_torch.ops.flash_prefill import prefill_attention
from vattention_tpu_torch.ops.utils import cdiv, select_kv_tile

# rows per arena-row-table entry (a divisor of the allocator's
# block_tokens, so one entry never straddles two extents)
TABLE_SUB = 256


class VattnAttentionBackend:
    """Holds the row-table geometry for a model/cache config."""

    def __init__(self, *, block_tokens: int, max_context_len: int,
                 arena_rows: int, q_tile: int = PREFILL_TOKEN_PAD):
        self.q_tile = q_tile
        self.sub = select_kv_tile(block_tokens, TABLE_SUB)
        self.n_sub = cdiv(min(max_context_len, arena_rows), self.sub)

    @staticmethod
    def _pad_heads(x: torch.Tensor, Dp: int) -> torch.Tensor:
        """Zero-pad the head dim to the arena's 128-aligned width (zeros
        are score-neutral)."""
        D = x.shape[-1]
        return x if D == Dp else F.pad(x, (0, Dp - D))

    def append_kv(self, kv_cache: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor, inputs: StepInputs, layer: int) -> None:
        """Write this step's K/V ([T, Hkv, D]) for one layer, in place."""
        Dp = kv_cache.shape[-1]
        k = self._pad_heads(k, Dp).to(kv_cache.dtype).contiguous()
        v = self._pad_heads(v, Dp).to(kv_cache.dtype).contiguous()
        kv_append(kv_cache, k, v, inputs.append_rows, layer)

    def attend(self, q: torch.Tensor, kv_cache: torch.Tensor,
               inputs: StepInputs, layer: int, n_prefill_tokens: int, *,
               sm_scale: float) -> torch.Tensor:
        """q: [T, Hq, D] -> [T, Hq, D]."""
        D = q.shape[-1]
        q = self._pad_heads(q, kv_cache.shape[-1])
        outs = []
        if n_prefill_tokens > 0:
            outs.append(prefill_attention(
                q[:n_prefill_tokens].contiguous(), kv_cache, inputs.qt_run,
                inputs.pre_qinfo, inputs.pre_tile_rows, layer, sub=self.sub,
                pad_tile=self.q_tile, sm_scale=sm_scale))
        if q.shape[0] > n_prefill_tokens:
            outs.append(decode_attention(
                q[n_prefill_tokens:].contiguous(), kv_cache,
                inputs.dec_tile_rows, inputs.dec_seqlens, layer,
                sub=self.sub, sm_scale=sm_scale))
        out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)
        return out[..., :D]
