"""POD fused prefill+decode backend (``fa_pod``, ``fa_pod_megacache``).

Counterpart of ``vattention_tpu/model_executor/attention/pod_backend.py``.
A step that mixes prefill runs and decode slots (``inputs.pod``, set by
the runner) rotates Q and K and appends K/V as the vattn backend does
(kernel A) and then attends through ONE launch of kernel F
(``ops/pod_fused.pod_attention``), which returns both outputs;
single-phase steps take the vattn backend's kernels B and C, as the JAX
backend falls back to them.  Every prefill run of the step fuses, at
any depth (the JAX runner's ``POD_KV_LEN_LIMIT`` fallback is not
carried: F loops to each run's live depth).  A model's
``sliding_window`` goes to F's both parts, as to B and C; the JAX POD
backend drops it, so the two diverge on windowed models by design
(ROADMAP Queue 3).
"""

from __future__ import annotations

import torch

from vattention_tpu_torch.model_executor.attention.vattn_backend import (
    VattnAttentionBackend)
from vattention_tpu_torch.model_executor.step_inputs import StepInputs
from vattention_tpu_torch.ops.pod_fused import pod_attention


class PodAttentionBackend(VattnAttentionBackend):
    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        # steps that attended through kernel F, counted by the runner (a
        # replayed step makes no call here)
        self.pod_steps = 0

    def attend(self, q: torch.Tensor, kv_cache: torch.Tensor,
               inputs: StepInputs, layer: int, n_prefill_tokens: int, *,
               sm_scale: float) -> torch.Tensor:
        """q: [T, Hq, D] -> [T, Hq, D]."""
        if not inputs.pod:
            return super().attend(q, kv_cache, inputs, layer,
                                  n_prefill_tokens, sm_scale=sm_scale)
        D = q.shape[-1]
        q = self._pad_heads(q, kv_cache.shape[-1])
        out_p, out_d = pod_attention(
            q[:n_prefill_tokens].contiguous(),
            q[n_prefill_tokens:].contiguous(), kv_cache, inputs.qt_run,
            inputs.pre_qinfo, inputs.pre_tile_rows, inputs.dec_tile_rows,
            inputs.dec_seqlens, layer, sub=self.sub, pad_tile=self.q_tile,
            sm_scale=self._eff_sm_scale(sm_scale), window=self.window)
        return self._descale_out(torch.cat([out_p, out_d], dim=0)[..., :D])
