"""NO_OP attention backend: skip KV writes and attention entirely.

Counterpart of ``vattention_tpu/model_executor/attention/no_op_backend.py``
-- used to profile the non-attention part of the model (linear layers,
norms) in isolation.  ``attend`` returns the query unchanged and
``rope_append_kv`` adds the qkv bias, if any, rotates the query (the
plain rope) and leaves the cache untouched, so a NO_OP run measures
everything *except* the attention/cache path.
"""

from __future__ import annotations

from vattention_tpu_torch.ops.cache_append import split_qkv


class NoOpAttentionBackend:
    def rope_append_kv(self, kv_cache, qkv, rope, inputs, layer: int,
                       bias=None):
        if bias is not None:
            qkv = qkv + bias
        q, k, _ = split_qkv(qkv, kv_cache.shape[2], rope.head_dim)
        return rope(inputs.positions, q, k)[0]

    def attend(self, q, kv_cache, inputs, layer: int,
               n_prefill_tokens: int, *, sm_scale: float):
        return q
