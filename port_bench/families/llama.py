"""The Llama family's weights (Llama, Yi; Mistral adds only a window):
their names, shapes and scales, and where each sits in the program's
parameters.

Scales keep the logits finite and spread and the attention sharp, so that
what the attention reads shows in the logits:

- embedding N(0, 1); norm weights 1 + N(0, 0.1^2);
- q and k projections N(0, s / H), so that a query-key score has a
  standard deviation of about s, the configuration's ``score_std``
  (``weights`` in its file): a softmax over N keys then puts its weight
  on about N exp(-s^2) of them, and s is set so that this is a handful
  at the depths the configuration's cells reach;
- v, o, gate, up, down N(0, 1 / fan_in), so each sublayer's output has
  about unit scale;
- lm head N(0, 4 / H): logits with a standard deviation of about 2.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, Tuple

LOGIT_VAR = 4.0


def shapes(d, score: float) -> Dict[str, Tuple[tuple, str, float]]:
    """name -> (shape, kind, std); layer weights stacked on [L]."""
    L, H, D = d.layers, d.hidden, d.head_dim
    qk = (score / H) ** 0.5
    return {
        "embed": ((d.vocab, H), "normal", 1.0),
        "input_norm": ((L, H), "norm", 0.1),
        "wq": ((L, H, d.q_heads * D), "normal", qk),
        "wk": ((L, H, d.kv_heads * D), "normal", qk),
        "wv": ((L, H, d.kv_heads * D), "normal", H ** -0.5),
        "wo": ((L, d.q_heads * D, H), "normal", (d.q_heads * D) ** -0.5),
        "post_norm": ((L, H), "norm", 0.1),
        "w_gate": ((L, H, d.inter), "normal", H ** -0.5),
        "w_up": ((L, H, d.inter), "normal", H ** -0.5),
        "w_down": ((L, d.inter, H), "normal", d.inter ** -0.5),
        "final_norm": ((H,), "norm", 0.1),
        "lm_head": ((H, d.vocab), "normal", (LOGIT_VAR / H) ** 0.5),
    }


# the program's parameter layout (model_executor/models/llama.py): per
# layer stacks of [in, out] projections, qkv and gate_up concatenated
PROGRAM = {
    "embed": ("embed", None), "final_norm": ("final_norm", None),
    "lm_head": ("lm_head", None),
    "input_norm": ("layers.input_norm", None),
    "post_norm": ("layers.post_norm", None),
    "wq": ("layers.qkv_w", 0), "wk": ("layers.qkv_w", 1),
    "wv": ("layers.qkv_w", 2), "wo": ("layers.o_w", None),
    "w_gate": ("layers.gate_up_w", 0), "w_up": ("layers.gate_up_w", 1),
    "w_down": ("layers.down_w", None),
}


def load_into_program(params: dict, d,
                      weights_on: Callable[..., Iterator]) -> None:
    """Copy the tensors ``weights_on(device, dtype)`` yields, as (name,
    tensor), into the program's parameters in place."""
    D = d.head_dim
    offsets = {"layers.qkv_w": [0, d.q_heads * D,
                                (d.q_heads + d.kv_heads) * D],
               "layers.gate_up_w": [0, d.inter]}
    seen = set()
    embed = params["embed"]
    for name, w in weights_on(embed.device, embed.dtype):
        target, part = PROGRAM[name]
        dst = (params["layers"][target.split(".", 1)[1]]
               if target.startswith("layers.") else params[target])
        if part is not None:
            at = offsets[target][part]
            dst = dst[..., at:at + w.shape[-1]]
        if tuple(dst.shape) != tuple(w.shape):
            raise ValueError(f"{name}: the program's {target} slice is "
                             f"{tuple(dst.shape)}, the weight "
                             f"{tuple(w.shape)}")
        dst.copy_(w)
        seen.add(target)
        del w
    names = set(params) - {"layers"} | {
        f"layers.{k}" for k in params["layers"]}
    if names != seen:
        raise ValueError(f"program parameters not filled: "
                         f"{sorted(names - seen)}")
