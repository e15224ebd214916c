"""vATTN attention backend: the port's kernels over the contiguous arena.

Counterpart of ``vattention_tpu/model_executor/attention/vattn_backend.py``
(``append_kv`` and ``attend``), for arenas of the model's dtype and for
e4m3 and int8 arenas.  Kernel A first rotates a layer's Q and K and
appends K/V (``rope_append_kv``: the JAX step's rope and append in one
launch, quantizing into a 1-byte arena), then the prefill region attends
through kernel B and the decode slots through kernel C; all three read
the arena through
host-resolved row tables at ``sub``-row granularity.  An int8 arena's step
``kv_scale`` costs the kernels nothing: it folds into ``sm_scale`` (scores
= q . K_int * sm_scale * kv_scale) and multiplies the attention output
once, in the output's dtype (softmax is invariant to V's scale), as the
JAX backend does.  A model's ``sliding_window`` goes to every prefill
and decode call.
"""

from __future__ import annotations

import torch

from vattention_tpu_torch.config import PREFILL_TOKEN_PAD
from vattention_tpu_torch.model_executor.step_inputs import StepInputs
from vattention_tpu_torch.ops.cache_append import rope_kv_append
from vattention_tpu_torch.ops.flash_decode import decode_attention
from vattention_tpu_torch.ops.flash_prefill import prefill_attention
from vattention_tpu_torch.ops.utils import cdiv, pad_heads, select_kv_tile

# rows per arena-row-table entry (a divisor of the allocator's
# block_tokens, so one entry never straddles two extents)
TABLE_SUB = 256


class VattnAttentionBackend:
    """Holds the row-table geometry for a model/cache config."""

    def __init__(self, *, block_tokens: int, max_context_len: int,
                 arena_rows: int, q_tile: int = PREFILL_TOKEN_PAD,
                 kv_scale: float | None = None,
                 sliding_window: int | None = None):
        self.kv_scale = kv_scale
        self.window = sliding_window
        self.q_tile = q_tile
        self.sub = select_kv_tile(block_tokens, TABLE_SUB)
        self.n_sub = cdiv(min(max_context_len, arena_rows), self.sub)

    _pad_heads = staticmethod(pad_heads)

    def _eff_sm_scale(self, sm_scale: float) -> float:
        return sm_scale if self.kv_scale is None else sm_scale * self.kv_scale

    def _descale_out(self, out: torch.Tensor) -> torch.Tensor:
        """out * kv_scale with kv_scale rounded to out's dtype first, as
        the JAX backend's ``out * jnp.asarray(kv_scale, out.dtype)``."""
        if self.kv_scale is None:
            return out
        return out * float(torch.tensor(self.kv_scale, dtype=out.dtype))

    def rope_append_kv(self, kv_cache: torch.Tensor, qkv: torch.Tensor,
                       rope, inputs: StepInputs, layer: int,
                       bias: torch.Tensor | None = None) -> torch.Tensor:
        """Add the layer's qkv ``bias`` (if any), rotate this step's Q and
        K for one layer and write its K/V into the cache, converted to the
        cache's dtype, in one launch of kernel A.  qkv: [T, (Hq + 2 Hkv) *
        D] of the model's dtype -> q [T, Hq, D]."""
        return rope_kv_append(kv_cache, qkv, inputs.positions,
                              inputs.append_rows, layer, rope,
                              kv_scale=self.kv_scale, bias=bias)

    def attend(self, q: torch.Tensor, kv_cache: torch.Tensor,
               inputs: StepInputs, layer: int, n_prefill_tokens: int, *,
               sm_scale: float) -> torch.Tensor:
        """q: [T, Hq, D] -> [T, Hq, D]."""
        D = q.shape[-1]
        q = self._pad_heads(q, kv_cache.shape[-1])
        sm_scale = self._eff_sm_scale(sm_scale)
        outs = []
        if n_prefill_tokens > 0:
            outs.append(prefill_attention(
                q[:n_prefill_tokens].contiguous(), kv_cache, inputs.qt_run,
                inputs.pre_qinfo, inputs.pre_tile_rows, layer, sub=self.sub,
                pad_tile=self.q_tile, sm_scale=sm_scale, window=self.window))
        if q.shape[0] > n_prefill_tokens:
            outs.append(decode_attention(
                q[n_prefill_tokens:].contiguous(), kv_cache,
                inputs.dec_tile_rows, inputs.dec_seqlens, layer,
                sub=self.sub, sm_scale=sm_scale, window=self.window))
        out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)
        return self._descale_out(out[..., :D])
