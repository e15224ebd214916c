"""NO_OP attention backend: skip KV writes and attention entirely.

Counterpart of ``vattention_tpu/model_executor/attention/no_op_backend.py``
-- used to profile the non-attention part of the model (linear layers,
norms) in isolation.  ``attend`` returns the query unchanged and
``append_kv`` leaves the cache untouched, so a NO_OP run measures
everything *except* the attention/cache path.
"""

from __future__ import annotations


class NoOpAttentionBackend:
    def append_kv(self, kv_cache, k, v, inputs, layer: int) -> None:
        pass

    def attend(self, q, kv_cache, inputs, layer: int,
               n_prefill_tokens: int, *, sm_scale: float):
        return q
