"""Paged attention backend (block tables), the A/B baseline.

Counterpart of ``vattention_tpu/model_executor/attention/paged_backend.py``.
Q and K are rotated and K/V appended first through kernel A (a per-row
scatter, so blocks narrower than the TPU's 32-row windows need no
``serialize``); then the prefill region attends through kernel E over
the per-run block tables and
the decode slots through kernel C over the runner's clamped row table at
``sub = block_size``.  The pool's dtype and an int8 step fold in as in the
vattn backend.  A model's ``sliding_window`` goes to both kernels; the JAX
runner builds its paged backend without it, so this backend diverges from
the JAX one on windowed models by design (ROADMAP Queue 3).
"""

from __future__ import annotations

import torch

from vattention_tpu_torch.config import PREFILL_TOKEN_PAD
from vattention_tpu_torch.model_executor.attention.vattn_backend import (
    VattnAttentionBackend)
from vattention_tpu_torch.model_executor.step_inputs import StepInputs
from vattention_tpu_torch.ops.flash_decode import decode_attention
from vattention_tpu_torch.ops.paged_attention import paged_prefill_attention


class PagedAttentionBackend:
    def __init__(self, *, block_size: int, q_tile: int = PREFILL_TOKEN_PAD,
                 kv_scale: float | None = None,
                 sliding_window: int | None = None):
        self.block_size = block_size
        self.q_tile = q_tile
        self.kv_scale = kv_scale
        self.window = sliding_window

    rope_append_kv = VattnAttentionBackend.rope_append_kv
    _pad_heads = staticmethod(VattnAttentionBackend._pad_heads)
    _eff_sm_scale = VattnAttentionBackend._eff_sm_scale
    _descale_out = VattnAttentionBackend._descale_out

    def attend(self, q: torch.Tensor, kv_cache: torch.Tensor,
               inputs: StepInputs, layer: int, n_prefill_tokens: int, *,
               sm_scale: float) -> torch.Tensor:
        """q: [T, Hq, D] -> [T, Hq, D]."""
        D = q.shape[-1]
        q = self._pad_heads(q, kv_cache.shape[-1])
        sm_scale = self._eff_sm_scale(sm_scale)
        outs = []
        if n_prefill_tokens > 0:
            outs.append(paged_prefill_attention(
                q[:n_prefill_tokens].contiguous(), kv_cache, inputs.qt_run,
                inputs.pre_qinfo, inputs.pre_block_tables, layer,
                block_size=self.block_size, pad_tile=self.q_tile,
                sm_scale=sm_scale, window=self.window))
        if q.shape[0] > n_prefill_tokens:
            outs.append(decode_attention(
                q[n_prefill_tokens:].contiguous(), kv_cache,
                inputs.dec_tile_rows, inputs.dec_seqlens, layer,
                sub=self.block_size, sm_scale=sm_scale, window=self.window))
        out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)
        return self._descale_out(out[..., :D])
