"""Llama-family model (llama/yi/mistral/qwen/internlm share this body).

Counterpart of ``vattention_tpu/model_executor/models/llama.py``.  Weights
are a plain dict of tensors in the JAX package's layout -- per-layer
weights stacked on a leading [L] axis, projections as [in, out] so the
forward is ``h @ w`` -- which makes ``weight_utils.params_from_jax`` a
plain copy.  The forward is a Python loop over layers: each layer runs
rms_norm -> qkv -> rope -> KV append (kernel A) -> attention (kernels
B/C) -> o-proj -> SwiGLU, one kernel launch per layer and op.  The arena
is updated in place.
"""

from __future__ import annotations

from typing import Dict

import torch

from vattention_tpu_torch.config import ModelArch
from vattention_tpu_torch.model_executor.layers.activation import silu_and_mul
from vattention_tpu_torch.model_executor.layers.layernorm import rms_norm
from vattention_tpu_torch.model_executor.layers.rotary_embedding import get_rope
from vattention_tpu_torch.model_executor.step_inputs import StepInputs

Params = Dict[str, object]


class LlamaForCausalLM:
    """Model definition + forward; weights live in a separate dict."""

    def __init__(self, arch: ModelArch, *, dtype: torch.dtype = torch.bfloat16):
        if arch.parallel_attn or arch.sliding_window is not None:
            raise NotImplementedError(
                f"{arch.model_type}: parallel attention and sliding windows "
                "are not ported yet (ROADMAP Queue 1 item 12)")
        self.arch = arch
        self.dtype = dtype
        self.hq = arch.num_q_heads
        self.hkv = arch.num_kv_heads
        self.head_dim = arch.head_dim
        self.inter = arch.intermediate_size
        self.rope = get_rope(arch.head_dim, arch.head_dim,
                             arch.max_position_embeddings, arch.rope_theta,
                             arch.rope_scaling)
        self.sm_scale = 1.0 / (arch.head_dim ** 0.5)

    def param_shapes(self) -> Dict[str, tuple]:
        """Flat name -> shape; layer weights carry the leading [L] axis
        and live under "layers.<name>"."""
        a = self.arch
        H, D, L = a.hidden_size, self.head_dim, a.num_layers
        qkv_out = (self.hq + 2 * self.hkv) * D
        shapes = {
            "embed": (a.vocab_size, H),
            "final_norm": (H,),
            "layers.input_norm": (L, H),
            "layers.qkv_w": (L, H, qkv_out),
            "layers.o_w": (L, self.hq * D, H),
            "layers.post_norm": (L, H),
            "layers.gate_up_w": (L, H, 2 * self.inter),
            "layers.down_w": (L, self.inter, H),
        }
        if a.qkv_bias:
            shapes["layers.qkv_b"] = (L, qkv_out)
        if not a.tie_word_embeddings:
            shapes["lm_head"] = (H, a.vocab_size)
        return shapes

    def init_params(self, device: torch.device, *, seed: int = 0,
                    zero: bool = False) -> Params:
        """Random (load_format=dummy) or zero weights, drawn on ``device``
        one layer at a time from a seeded generator: norms are ones, qkv
        biases zeros, every other weight N(0, 0.02^2)."""
        gen = None if zero else torch.Generator(device=device).manual_seed(seed)
        params: Params = {"layers": {}}
        for name, shape in self.param_shapes().items():
            t = torch.empty(shape, dtype=self.dtype, device=device)
            short = name.split(".")[-1]
            if short.endswith("norm"):
                t.fill_(1.0)
            elif zero or short == "qkv_b":
                t.zero_()
            else:
                for part in (t if name.startswith("layers.") else [t]):
                    part.copy_(torch.randn(part.shape, generator=gen,
                                           device=device) * 0.02)
            if name.startswith("layers."):
                params["layers"][short] = t
            else:
                params[name] = t
        return params

    # ------------------------------------------------------------------ #
    def embed(self, params: Params, token_ids: torch.Tensor) -> torch.Tensor:
        return params["embed"][token_ids]  # [T, H]

    def run_layers(self, params: Params, kv_cache: torch.Tensor,
                   x: torch.Tensor, inputs: StepInputs, backend,
                   n_prefill_tokens: int) -> torch.Tensor:
        a = self.arch
        D = self.head_dim
        lp = params["layers"]
        T = x.shape[0]
        for layer in range(a.num_layers):
            h = rms_norm(x, lp["input_norm"][layer], a.rms_norm_eps)
            qkv = h @ lp["qkv_w"][layer]
            if "qkv_b" in lp:
                qkv = qkv + lp["qkv_b"][layer]
            q = qkv[:, :self.hq * D].reshape(T, self.hq, D)
            k = qkv[:, self.hq * D:(self.hq + self.hkv) * D].reshape(
                T, self.hkv, D)
            v = qkv[:, (self.hq + self.hkv) * D:].reshape(T, self.hkv, D)
            q, k = self.rope(inputs.positions, q, k)
            backend.append_kv(kv_cache, k, v, inputs, layer)
            attn = backend.attend(q, kv_cache, inputs, layer,
                                  n_prefill_tokens, sm_scale=self.sm_scale)
            x = x + attn.reshape(T, self.hq * D) @ lp["o_w"][layer]
            h2 = rms_norm(x, lp["post_norm"][layer], a.rms_norm_eps)
            x = x + silu_and_mul(h2 @ lp["gate_up_w"][layer]) @ lp["down_w"][layer]
        return x

    def head(self, params: Params, x: torch.Tensor,
             sample_idx: torch.Tensor) -> torch.Tensor:
        """Logits [B, V] in float32 for the rows ``sample_idx`` (clamped)."""
        a = self.arch
        x = rms_norm(x, params["final_norm"], a.rms_norm_eps)
        hs = x[sample_idx.clamp(0, x.shape[0] - 1)]  # [B, H]
        head = (params["embed"].T if a.tie_word_embeddings
                else params["lm_head"])
        # the products of the bf16 values, summed in float32 (float32
        # matmuls run without TF32, see model_runner)
        if hs.is_cuda and hs.dtype == torch.bfloat16:
            # one GEMM with a float32 output: no float32 copy of the head
            return torch.mm(hs, head, out_dtype=torch.float32)
        return hs.float() @ head.float()  # the CPU has no such GEMM

    def forward(self, params: Params, kv_cache: torch.Tensor,
                inputs: StepInputs, backend,
                n_prefill_tokens: int) -> torch.Tensor:
        """Returns logits [B, V] float32; the arena is updated in place."""
        x = self.embed(params, inputs.token_ids)
        x = self.run_layers(params, kv_cache, x, inputs, backend,
                            n_prefill_tokens)
        return self.head(params, x, inputs.sample_idx)
