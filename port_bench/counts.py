"""Operations and bytes of a serving step, counted from its shapes.

The work is counted as the model defines it, whatever runs it: real
tokens only (no padding rows), every layer, each K/V row read once, each
weight read once a step.  The shapes come from what the scheduler
dispatched (``Step``): each prompt chunk's length and the keys before it,
each decoding sequence's length.

- projections and MLP: 2 x (qkv + o + gate_up + down) weights per token
  and layer;
- lm head: 2 x H x V per sampled row;
- attention: 4 x Hq x D per attended key and layer (QK^T and PV), causal,
  each query attending at most ``window`` keys (Mistral's window).

``bench.py``'s attention count left out the number of layers; here every
count has it.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from port_bench import peaks

BF16 = 2


@dataclass(frozen=True)
class Dims:
    layers: int
    hidden: int
    q_heads: int
    kv_heads: int
    head_dim: int
    inter: int
    vocab: int
    window: Optional[int] = None
    kv_bytes: int = BF16     # bytes of one K/V element in the arena
    up: int = 0              # the MLP's up projection width; 0: gated,
                             # gate and up side by side, 2 x inter
    act_bytes: int = BF16    # bytes of one activation or weight element

    @classmethod
    def of(cls, cfg: dict) -> "Dims":
        h, heads = cfg["hidden_size"], cfg["num_attention_heads"]
        return cls(layers=cfg["num_hidden_layers"], hidden=h,
                   q_heads=heads,
                   kv_heads=cfg.get("num_key_value_heads", heads),
                   head_dim=cfg.get("head_dim") or h // heads,
                   inter=cfg["intermediate_size"], vocab=cfg["vocab_size"],
                   window=cfg.get("sliding_window"))

    @property
    def qkv_out(self) -> int:
        return (self.q_heads + 2 * self.kv_heads) * self.head_dim


@dataclass
class Step:
    """One dispatched step: prompt chunks as (length, keys before it),
    decoding sequences by their length (keys, the new one included), and
    the rows that sample a token."""
    t: float
    chunks: List[Tuple[int, int]] = field(default_factory=list)
    decodes: List[int] = field(default_factory=list)
    sampled: int = 0
    held: int = 0        # K/V tokens the live sequences hold after it

    @property
    def tokens(self) -> int:
        return sum(c for c, _ in self.chunks) + len(self.decodes)


def kv_bytes_per_token(d: "Dims") -> int:
    """Arena bytes one token's K and V take over every layer."""
    return 2 * d.layers * d.kv_heads * d.head_dim * d.kv_bytes


def keys_attended(start: int, n: int, window: Optional[int]) -> int:
    """Sum over the queries at positions start..start+n-1 of the keys each
    attends: min(p + 1, window)."""
    if n <= 0:
        return 0
    lo, hi = start + 1, start + n          # p + 1 runs over [lo, hi]
    if window is None or hi <= window:
        return (lo + hi) * n // 2
    if lo >= window:
        return window * n
    full = hi - window                     # queries that see the window
    part = window - lo                     # lo .. window - 1
    return (lo + window - 1) * part // 2 + window * (full + 1)


def kv_rows(start: int, n: int, window: Optional[int]) -> int:
    """Distinct K/V rows the queries start..start+n-1 read."""
    end = start + n
    if window is None:
        return end
    return end - max(0, start - window + 1)


def gemm_calls(d: Dims, tokens: int, sampled: int):
    """(FLOPs, bytes) of each projection call of a step with ``tokens``
    rows, one per layer and weight, and the lm head over ``sampled``
    rows: the weight, the input and the output each moved once."""
    H, a = d.hidden, d.act_bytes
    shapes = [(H, d.qkv_out), (d.q_heads * d.head_dim, H),
              (H, d.up or 2 * d.inter), (d.inter, H)]
    calls = []
    if tokens:
        for k, n in shapes:
            calls.append((d.layers, 2 * tokens * k * n,
                          (k * n + tokens * (k + n)) * a))
    if sampled:
        # the head's float32 logits out
        calls.append((1, 2 * sampled * H * d.vocab,
                      H * d.vocab * a + sampled * H * a
                      + sampled * d.vocab * 4))
    return calls


def step_flops(d: Dims, s: Step) -> float:
    """Every operation of the step: projections, MLP, lm head, attention."""
    gemm = sum(n * f for n, f, _ in gemm_calls(d, s.tokens, s.sampled))
    keys = sum(keys_attended(st, c, d.window) for c, st in s.chunks)
    keys += sum(min(n, d.window or n) for n in s.decodes)
    return gemm + 4.0 * d.q_heads * d.head_dim * keys * d.layers


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the two
    roofs."""
    return max(flops / peaks.BF16_FLOPS, nbytes / peaks.HBM_BYTES_PER_S)


def gemm_bound_s(d: Dims, s: Step) -> float:
    """The least time of the step's projection calls, call by call."""
    return sum(n * bound_s(f, b)
               for n, f, b in gemm_calls(d, s.tokens, s.sampled))


def prefill_attn(d: Dims, s: Step) -> Tuple[float, float]:
    """(FLOPs, bytes) of one layer's prefill attention call (kernel B):
    Q in, O out, and each chunk's K/V rows read once."""
    if not s.chunks:
        return 0.0, 0.0
    qo = 2 * d.q_heads * d.head_dim * d.act_bytes
    kv = 2 * d.kv_heads * d.head_dim * d.kv_bytes
    keys = sum(keys_attended(st, c, d.window) for c, st in s.chunks)
    rows = sum(kv_rows(st, c, d.window) for c, st in s.chunks)
    tokens = sum(c for c, _ in s.chunks)
    return (4.0 * d.q_heads * d.head_dim * keys, tokens * qo + rows * kv)


def decode_attn(d: Dims, s: Step) -> Tuple[float, float]:
    """(FLOPs, bytes) of one layer's decode attention call (kernel C):
    each sequence's query and output, its (windowed) K/V rows once."""
    if not s.decodes:
        return 0.0, 0.0
    qo = 2 * d.q_heads * d.head_dim * d.act_bytes
    kv = 2 * d.kv_heads * d.head_dim * d.kv_bytes
    keys = sum(min(n, d.window or n) for n in s.decodes)
    return (4.0 * d.q_heads * d.head_dim * keys,
            len(s.decodes) * qo + keys * kv)


def attn_bound_s(d: Dims, s: Step, which: str) -> float:
    """The least time of the step's ``which`` ("prefill" or "decode")
    attention calls over every layer."""
    f, b = (prefill_attn if which == "prefill" else decode_attn)(d, s)
    if not f:
        return 0.0
    return d.layers * bound_s(f, b)
