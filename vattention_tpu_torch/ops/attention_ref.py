"""Dense reference attention in plain PyTorch (float32 arithmetic).

Counterpart of ``vattention_tpu/ops/attention_ref.py``: the definitions the
kernels' results are held against.
"""

from __future__ import annotations

import torch


def mha_reference(q, k, v, *, causal: bool, q_start: int = 0,
                  sm_scale: float | None = None, window: int | None = None):
    """q: [Tq, Hq, D]; k/v: [Tk, Hkv, D] (GQA: Hq = G*Hkv).

    ``q_start``: absolute position of q[0] (query i sits at q_start + i).
    ``window`` (causal only; None or 0: none): query position q attends
    keys p with q - window < p <= q, the kernels' sliding window.
    """
    Tq, Hq, D = q.shape
    Tk, Hkv, _ = k.shape
    G = Hq // Hkv
    if sm_scale is None:
        sm_scale = 1.0 / (D ** 0.5)
    qf = q.float().reshape(Tq, Hkv, G, D)
    scores = torch.einsum("qhgd,khd->hgqk", qf, k.float()) * sm_scale
    if causal:
        q_pos = q_start + torch.arange(Tq, device=q.device)[:, None]
        k_pos = torch.arange(Tk, device=q.device)[None, :]
        seen = q_pos >= k_pos
        if window:
            seen &= k_pos > q_pos - window
        scores = scores.masked_fill(~seen, float("-inf"))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("hgqk,khd->qhgd", p, v.float())
    return out.reshape(Tq, Hq, D)


def decode_reference(q, k_cache, v_cache, seqlens, *, sm_scale=None):
    """q: [B, Hq, D]; caches: [B, R, Hkv, D] (already gathered per seq);
    seqlens: [B]. Each q attends rows [0, seqlens[b]); seqlen 0 gives 0."""
    B, Hq, D = q.shape
    _, R, Hkv, _ = k_cache.shape
    G = Hq // Hkv
    if sm_scale is None:
        sm_scale = 1.0 / (D ** 0.5)
    qf = q.float().reshape(B, Hkv, G, D)
    scores = torch.einsum("bhgd,bkhd->bhgk", qf, k_cache.float()) * sm_scale
    mask = (torch.arange(R, device=q.device)[None, :]
            < seqlens.to(q.device)[:, None])
    scores = scores.masked_fill(~mask[:, None, None], float("-inf"))
    p = torch.nan_to_num(torch.softmax(scores, dim=-1), nan=0.0)
    out = torch.einsum("bhgk,bkhd->bhgd", p, v_cache.float())
    return out.reshape(B, Hq, D)
