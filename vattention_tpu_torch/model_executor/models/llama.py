"""Llama-family model (llama/yi/mistral/qwen/qwen2/internlm share this body).

Counterpart of ``vattention_tpu/model_executor/models/llama.py``.  Weights
are a plain dict of tensors in the JAX package's layout -- per-layer
weights stacked on a leading [L] axis, projections as [in, out] so the
forward is ``h @ w`` -- which makes ``weight_utils.params_from_jax`` a
plain copy.  The forward is a Python loop over layers: each layer runs
residual add + rms_norm (one kernel) -> qkv -> qkv bias + rope + KV
append (one launch of kernel A) -> attention (kernels B/C) -> o-proj ->
residual add + rms_norm -> gate_up -> SiLU-and-mul (one kernel) -> down,
one kernel launch per layer and op, and no host wait
(``ops/norm_act.py``).  The residual is carried as the reference's
serving stack carries it: each layer's MLP output is added inside the
next layer's input norm, and the last layer's inside the final norm
(``run_layers(..., carry=True)``, then ``head``).  The arena is updated
in place.  A sliding window (``ModelArch.sliding_window``, mistral) is
the attention backend's, and a qkv bias (qwen, internlm) is a weight
that kernel A adds.  Falcon's
parallel attention is its own subclass (``models/falcon.py``), which
reuses this class's constructor, parameter drawing and logits.

Under tensor and pipeline parallelism (a ``parallel.mesh.ServingMesh``)
the model is one rank's: ``hq``, ``hkv`` and ``inter`` are the tp shard's
(the JAX model's per-shard widths), the weights hold the stage's layers
(``parallel.sharding``), ``run_layers`` loops over them with the arena's
local layer index, and the products of o and down are summed over tp
(``ServingMesh.all_reduce_tp``) where the JAX model's ``psum``s sit,
before they are added to the residual.  A stage hands the next one its
residual fully summed.
"""

from __future__ import annotations

from typing import Dict

import torch

from vattention_tpu_torch.config import ModelArch
from vattention_tpu_torch.model_executor.layers.rotary_embedding import get_rope
from vattention_tpu_torch.model_executor.step_inputs import StepInputs
from vattention_tpu_torch.ops.norm_act import add_rms_norm, silu_and_mul
from vattention_tpu_torch.parallel.sharding import ShardLayout, check_tp

Params = Dict[str, object]


class LlamaForCausalLM:
    """Model definition + forward; weights live in a separate dict."""

    # whether this class computes attention and the MLP in parallel from
    # one norm (falcon's subclass); ModelArch.parallel_attn must agree
    parallel_attn = False

    def __init__(self, arch: ModelArch, *, dtype: torch.dtype = torch.bfloat16,
                 mesh=None):
        if arch.parallel_attn != self.parallel_attn:
            raise NotImplementedError(
                f"{arch.model_type}: parallel_attn={arch.parallel_attn} "
                f"does not fit {type(self).__name__}'s layer")
        self.arch = arch
        self.dtype = dtype
        self.mesh = mesh
        self.layout = ShardLayout.of(mesh)
        tp = self.layout.tp
        check_tp(arch, tp)
        self.hq = arch.num_q_heads // tp
        self.hkv = arch.num_kv_heads // tp
        self.head_dim = arch.head_dim
        self.inter = arch.intermediate_size // tp
        self.rope = get_rope(arch.head_dim, arch.head_dim,
                             arch.max_position_embeddings, arch.rope_theta,
                             arch.rope_scaling)
        self.sm_scale = 1.0 / (arch.head_dim ** 0.5)

    def param_shapes(self) -> Dict[str, tuple]:
        """Flat name -> shape of the one-rank model's weights; layer
        weights carry the leading [L] axis and live under
        "layers.<name>"."""
        a = self.arch
        H, D, L = a.hidden_size, self.head_dim, a.num_layers
        hq, hkv, inter = a.num_q_heads, a.num_kv_heads, a.intermediate_size
        qkv_out = (hq + 2 * hkv) * D
        shapes = {
            "embed": (a.vocab_size, H),
            "final_norm": (H,),
            "layers.input_norm": (L, H),
            "layers.qkv_w": (L, H, qkv_out),
            "layers.o_w": (L, hq * D, H),
            "layers.post_norm": (L, H),
            "layers.gate_up_w": (L, H, 2 * inter),
            "layers.down_w": (L, inter, H),
        }
        if a.qkv_bias:
            shapes["layers.qkv_b"] = (L, qkv_out)
        if not a.tie_word_embeddings:
            shapes["lm_head"] = (H, a.vocab_size)
        return shapes

    def init_params(self, device: torch.device, *, seed: int = 0,
                    zero: bool = False) -> Params:
        """Random (load_format=dummy) or zero weights, drawn on ``device``
        one layer at a time from a seeded generator: norms are ones, biases
        (``*_b``: qkv and norm biases) zeros, every other weight
        N(0, 0.02^2).  Every rank draws every layer of the one-rank model
        in the same order and keeps its shard, so the ranks together hold
        the one-rank model's weights."""
        gen = None if zero else torch.Generator(device=device).manual_seed(seed)
        stage = self.layout.stage_layers(self.arch.num_layers)

        def draw(shape, short):
            t = torch.empty(shape, dtype=self.dtype, device=device)
            if short.endswith("norm"):
                t.fill_(1.0)
            elif zero or short.endswith("_b"):
                t.zero_()
            else:
                t.copy_(torch.randn(shape, generator=gen, device=device)
                        * 0.02)
            return t

        params: Params = {"layers": {}}
        for name, shape in self.param_shapes().items():
            short = name.split(".")[-1]
            if not name.startswith("layers."):
                params[name] = draw(shape, short)
                continue
            stack = None
            for layer in range(shape[0]):
                w = draw(shape[1:], short)
                if layer not in stage:
                    continue
                w = self.layout.shard_layer(self.arch, short, w)
                if stack is None:
                    stack = torch.empty((len(stage),) + tuple(w.shape),
                                        dtype=self.dtype, device=device)
                stack[layer - stage.start].copy_(w)
            params["layers"][short] = stack
        return params

    def _tp_sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over tp (the JAX model's ``psum``)."""
        return x if self.mesh is None else self.mesh.all_reduce_tp(x)

    # ------------------------------------------------------------------ #
    def embed(self, params: Params, token_ids: torch.Tensor) -> torch.Tensor:
        return params["embed"][token_ids]  # [T, H]

    def run_layers(self, params: Params, kv_cache: torch.Tensor,
                   x: torch.Tensor, inputs: StepInputs, backend,
                   n_prefill_tokens: int, *, carry: bool = False):
        """The stage's layers over the residual ``x`` [T, H].  Returns the
        residual after them; with ``carry`` returns ``(x, tail)``, the
        last layer's MLP output (``tail``, None without layers) not yet
        added, for ``head`` to add inside the final norm."""
        a = self.arch
        D = self.head_dim
        lp = params["layers"]
        T = x.shape[0]
        mlp = None
        # the stage's layers; ``layer`` indexes the rank's arena too
        for layer in range(lp["input_norm"].shape[0]):
            x, h = add_rms_norm(x, mlp, lp["input_norm"][layer],
                                a.rms_norm_eps)
            q = backend.rope_append_kv(
                kv_cache, h @ lp["qkv_w"][layer], self.rope, inputs, layer,
                bias=lp["qkv_b"][layer] if "qkv_b" in lp else None)
            attn = backend.attend(q, kv_cache, inputs, layer,
                                  n_prefill_tokens, sm_scale=self.sm_scale)
            o = self._tp_sum(attn.reshape(T, self.hq * D) @ lp["o_w"][layer])
            x, h2 = add_rms_norm(x, o, lp["post_norm"][layer],
                                 a.rms_norm_eps)
            mlp = self._tp_sum(silu_and_mul(h2 @ lp["gate_up_w"][layer])
                               @ lp["down_w"][layer])
        if carry:
            return x, mlp
        return x if mlp is None else x + mlp

    def head(self, params: Params, x: torch.Tensor,
             sample_idx: torch.Tensor, tail=None) -> torch.Tensor:
        """Logits [B, V] in float32 for the rows ``sample_idx`` (clamped),
        ``tail`` (``run_layers``' carry) added to ``x`` inside the final
        norm."""
        _, x = add_rms_norm(x, tail, params["final_norm"],
                            self.arch.rms_norm_eps)
        return self.logits(params, x, sample_idx)

    def logits(self, params: Params, x: torch.Tensor,
               sample_idx: torch.Tensor) -> torch.Tensor:
        """The LM head on the normalized rows ``sample_idx`` (clamped) ->
        [B, V] float32."""
        a = self.arch
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
        x, tail = self.run_layers(params, kv_cache, x, inputs, backend,
                                  n_prefill_tokens, carry=True)
        return self.head(params, x, inputs.sample_idx, tail)
