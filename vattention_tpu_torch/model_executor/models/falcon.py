"""Falcon (Falcon-7B): parallel attention and MLP from one LayerNorm, MQA.

Counterpart of ``vattention_tpu/model_executor/models/falcon.py``.  Each
layer normalizes its input once with a biased LayerNorm (float32, eps
1e-5) and feeds the same ``h`` to attention and to a GELU MLP
(``gelu_new``, no gate); both outputs go into the residual together, as
``x + (o + mlp)`` in the JAX order, which bf16 rounding makes part of the
result; that sum is taken inside the next LayerNorm's kernel (the final
norm's after the last layer, ``ops/norm_act.add_layer_norm``), and
``gelu_new`` is a kernel too.  The fused qkv is laid out ``[q | k | v]``
as in the llama body, so kernel A rotates Q and K and appends K/V
exactly as for llama (one launch per layer), and the attention backends
take Falcon-7B's 71 query heads on 1 kv head (head dim 64, padded to the
arena's 128) through the same kernels.  Parameter names follow the JAX pytree (``input_norm``,
``input_norm_b``, ``qkv_w``, ``o_w``, ``up_w``, ``down_w``, ``embed``,
``final_norm``, ``final_norm_b``, ``lm_head``), so
``weight_utils.params_from_jax`` carries JAX weights across unchanged;
``lm_head`` is always its own weight, as in the JAX model.
"""

from __future__ import annotations

from typing import Dict

import torch

from vattention_tpu_torch.model_executor.models.llama import (LlamaForCausalLM,
                                                              Params)
from vattention_tpu_torch.model_executor.step_inputs import StepInputs
from vattention_tpu_torch.ops.norm_act import add_layer_norm, gelu_new

LN_EPS = 1e-5  # the JAX model's LayerNorm epsilon


class FalconForCausalLM(LlamaForCausalLM):
    parallel_attn = True

    def __init__(self, arch, *, dtype: torch.dtype = torch.bfloat16,
                 mesh=None):
        # the JAX mesh cannot split falcon either: its partition specs do
        # not name up_w and the norm biases, and 71 q heads divide over no
        # tp > 1
        if mesh is not None and (mesh.tp_size > 1 or mesh.pp_size > 1):
            raise NotImplementedError(
                "falcon under tensor or pipeline parallelism")
        super().__init__(arch, dtype=dtype, mesh=mesh)

    def param_shapes(self) -> Dict[str, tuple]:
        a = self.arch
        H, D, L = a.hidden_size, self.head_dim, a.num_layers
        return {
            "embed": (a.vocab_size, H),
            "final_norm": (H,),
            "final_norm_b": (H,),
            "layers.input_norm": (L, H),
            "layers.input_norm_b": (L, H),
            "layers.qkv_w": (L, H, (self.hq + 2 * self.hkv) * D),
            "layers.o_w": (L, self.hq * D, H),
            "layers.up_w": (L, H, self.inter),
            "layers.down_w": (L, self.inter, H),
            "lm_head": (H, a.vocab_size),
        }

    def run_layers(self, params: Params, kv_cache: torch.Tensor,
                   x: torch.Tensor, inputs: StepInputs, backend,
                   n_prefill_tokens: int, *, carry: bool = False):
        """As the llama body's; the carried ``tail`` is the last layer's
        ``(o, mlp)``."""
        D = self.head_dim
        lp = params["layers"]
        T = x.shape[0]
        o = mlp = None
        for layer in range(lp["input_norm"].shape[0]):
            x, h = add_layer_norm(x, o, mlp, lp["input_norm"][layer],
                                  lp["input_norm_b"][layer], LN_EPS)
            q = backend.rope_append_kv(kv_cache, h @ lp["qkv_w"][layer],
                                       self.rope, inputs, layer)
            attn = backend.attend(q, kv_cache, inputs, layer,
                                  n_prefill_tokens, sm_scale=self.sm_scale)
            o = attn.reshape(T, self.hq * D) @ lp["o_w"][layer]
            mlp = gelu_new(h @ lp["up_w"][layer]) @ lp["down_w"][layer]
        tail = None if o is None else (o, mlp)
        if carry:
            return x, tail
        return x if tail is None else x + (o + mlp)

    def head(self, params: Params, x: torch.Tensor,
             sample_idx: torch.Tensor, tail=None) -> torch.Tensor:
        o, mlp = tail or (None, None)
        _, x = add_layer_norm(x, o, mlp, params["final_norm"],
                              params["final_norm_b"], LN_EPS)
        return self.logits(params, x, sample_idx)
