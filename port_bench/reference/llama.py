"""Plain float32 forward of the Llama family (Llama, Yi, Mistral).

The published equations, in plain ``torch``, without the program's kernels,
cache or batching, and importing nothing of it:

    x   = embed[ids]
    per layer:
        h   = rms_norm(x) * input_norm
        q, k, v = h Wq, h Wk, h Wv        (GQA: q head i reads kv head i // G)
        q, k = rope(q), rope(k)           (rotate-half, theta from the config)
        a   = softmax(q k^T / sqrt(D) + causal mask [+ window]) v
        x   = x + a Wo
        h   = rms_norm(x) * post_norm
        x   = x + (silu(h Wgate) * (h Wup)) Wdown
    logits = (rms_norm(x) * final_norm) lm_head

Mistral's window: the query at position p sees keys j with
p - window < j <= p.  Everything is float32 with TF32 off; the RoPE
angles are worked out in float64.  One sequence at a time, layer by
layer over all its positions, queries and MLP rows in blocks, so that a
64K-token sequence fits beside the weights.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

F32 = torch.float32


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    """cos, sin [N, D/2] of the rotate-half RoPE, angles in float64."""
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float64,
                                        device=positions.device) / head_dim))
    ang = positions.to(torch.float64)[:, None] * inv[None, :]
    return torch.cos(ang).to(F32), torch.sin(ang).to(F32)


def rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x [N, heads, D]: the two halves of each head rotated."""
    x1, x2 = x.chunk(2, dim=-1)
    c, s = cos[:, None, :], sin[:, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def attention(q, k, v, window: Optional[int], block: int):
    """Causal GQA attention of one sequence: q [N, Hq, D], k and v
    [N, Hkv, D] -> [N, Hq, D], queries in blocks of ``block``."""
    N, hq, D = q.shape
    hkv = k.shape[1]
    G = hq // hkv
    scale = D ** -0.5
    out = torch.empty_like(q)
    kt = k.permute(1, 2, 0)                      # [Hkv, D, N]
    vt = v.permute(1, 0, 2)                      # [Hkv, N, D]
    pos = torch.arange(N, device=q.device)
    for s in range(0, N, block):
        e = min(N, s + block)
        k0 = 0 if window is None else max(0, s - window + 1)
        qb = q[s:e].reshape(e - s, hkv, G, D).permute(1, 2, 0, 3)
        sc = (qb.reshape(hkv, G * (e - s), D) @ kt[:, :, k0:e]) * scale
        sc = sc.view(hkv, G, e - s, e - k0)
        qp = pos[s:e, None]
        # only the block's own keys can lie after a query, and only the
        # first e - window keys before a query's window: mask those
        # columns alone
        kp = pos[None, s:e]
        sc[..., s - k0:].masked_fill_(kp > qp, float("-inf"))
        if window is not None and e - window > k0:
            kp = pos[None, k0:e - window]
            sc[..., :e - window - k0].masked_fill_(kp <= qp - window,
                                                   float("-inf"))
        p = torch.softmax(sc, dim=-1).view(hkv, G * (e - s), e - k0)
        ob = (p @ vt[:, k0:e]).view(hkv, G, e - s, D)
        out[s:e] = ob.permute(2, 0, 1, 3).reshape(e - s, hq, D)
    return out


class Reference:
    """The forward pass over the seed's weights (the names of
    ``families/llama.py``), given as a dict of tensors of any dtype."""

    def __init__(self, cfg: dict, weights: Dict[str, torch.Tensor], *,
                 q_block: int = 256, row_block: int = 4096):
        self.cfg = cfg
        self.w = weights
        self.hq = cfg["num_attention_heads"]
        self.hkv = cfg.get("num_key_value_heads", self.hq)
        self.D = cfg.get("head_dim") or cfg["hidden_size"] // self.hq
        self.eps = cfg.get("rms_norm_eps", 1e-5)
        self.theta = float(cfg.get("rope_theta", 10000.0))
        self.window = cfg.get("sliding_window")
        self.q_block = q_block
        self.row_block = row_block

    def _layer(self, x: torch.Tensor, i: int, cos, sin) -> torch.Tensor:
        w, N = self.w, x.shape[0]
        f = lambda name: w[name][i].to(F32)  # noqa: E731
        h = rms_norm(x, f("input_norm"), self.eps)
        q = rope((h @ f("wq")).view(N, self.hq, self.D), cos, sin)
        k = rope((h @ f("wk")).view(N, self.hkv, self.D), cos, sin)
        v = (h @ f("wv")).view(N, self.hkv, self.D)
        del h
        a = attention(q, k, v, self.window, self.q_block)
        del q, k, v
        x = x + a.view(N, self.hq * self.D) @ f("wo")
        del a
        wg, wu, wd, wp = f("w_gate"), f("w_up"), f("w_down"), f("post_norm")
        for s in range(0, N, self.row_block):
            h = rms_norm(x[s:s + self.row_block], wp, self.eps)
            x[s:s + self.row_block] += (
                torch.nn.functional.silu(h @ wg) * (h @ wu)) @ wd
        return x

    @torch.no_grad()
    def logits(self, ids: Sequence[int], rows: Sequence[int]
               ) -> torch.Tensor:
        """float32 logits [len(rows), V] at positions ``rows`` of the
        sequence ``ids``."""
        dev = self.w["embed"].device
        ids_t = torch.as_tensor(list(ids), dtype=torch.long, device=dev)
        x = self.w["embed"][ids_t].to(F32)
        cos, sin = rope_tables(torch.arange(len(ids_t), device=dev),
                               self.D, self.theta)
        for i in range(self.cfg["num_hidden_layers"]):
            x = self._layer(x, i, cos, sin)
        rows_t = torch.as_tensor(list(rows), dtype=torch.long, device=dev)
        h = rms_norm(x[rows_t], self.w["final_norm"].to(F32), self.eps)
        return h @ self.w["lm_head"].to(F32)
