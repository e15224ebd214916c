"""Token sampler (counterpart of vattention_tpu/model_executor/layers/sampler.py).

Greedy + temperature/top-k/top-p sampling over each slot's last-token
logits.  The JAX sampler decides inside its program whether the step
filters (``lax.cond``); here the host decides from the step's sampling
arrays, before the step runs (``sampler_mode``), and the sampler takes
that mode as an argument.  So the sampler reads nothing back from the
device and a CUDA graph can hold it: the mode is part of the captured
step's signature.  Random draws come from an explicit ``torch.Generator``,
so sampled (non-greedy) tokens differ from the JAX package's; greedy
tokens are the same argmax.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

# sampler modes: every slot greedy; some slot samples; some sampling slot
# also restricts top-k or top-p (the [B, V] sort runs)
GREEDY, SAMPLE, FILTER = "greedy", "sample", "filter"


def sampler_mode(temperatures: np.ndarray, top_p: np.ndarray,
                 top_k: np.ndarray, vocab_size: int) -> str:
    """The mode of a step from its host-side sampling arrays ([B] each):
    the branches the sampler took on the device before it took a mode."""
    greedy = np.asarray(temperatures) < 1e-5
    if greedy.all():
        return GREEDY
    top_k = np.asarray(top_k)
    need_filter = (~greedy) & (((top_k > 0) & (top_k < vocab_size))
                               | (np.asarray(top_p) < 1.0))
    return FILTER if need_filter.any() else SAMPLE


def sample_tokens(
    logits: torch.Tensor,        # [B, V] float32
    temperatures: torch.Tensor,  # [B] (0 => greedy)
    top_p: torch.Tensor,         # [B]
    top_k: torch.Tensor,         # [B] int32 (-1 disables)
    mode: str,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Tokens [B] int32.  ``mode`` is ``sampler_mode`` of the same arrays,
    worked out on the host."""
    B, V = logits.shape
    argmax = torch.argmax(logits, dim=-1)
    if mode == GREEDY:
        return argmax.to(torch.int32)
    greedy = temperatures < 1e-5
    temps = torch.where(greedy, torch.ones_like(temperatures), temperatures)
    scaled = logits / temps[:, None]
    if mode == FILTER:
        sorted_logits = torch.sort(scaled, dim=-1, descending=True).values
        k = torch.where(top_k <= 0, torch.full_like(top_k, V), top_k)
        kth = torch.gather(sorted_logits, 1,
                           (k[:, None] - 1).clamp(0, V - 1).long())
        scaled = scaled.masked_fill(scaled < kth, float("-inf"))
        sorted_probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(sorted_probs, dim=-1)
        # keep tokens while the exclusive cumulative probability < top_p
        keep = (cum - sorted_probs) < top_p[:, None]
        thresh = torch.where(keep, sorted_logits,
                             torch.full_like(sorted_logits, float("inf"))
                             ).min(dim=-1, keepdim=True).values
        scaled = scaled.masked_fill(scaled < thresh, float("-inf"))
    sampled = torch.multinomial(torch.softmax(scaled, dim=-1), 1,
                                generator=generator)[:, 0]
    return torch.where(greedy, argmax, sampled).to(torch.int32)


def pack_samples(logits: torch.Tensor, tokens: torch.Tensor,
                 n_top: int = 0) -> torch.Tensor:
    """Tokens and their logprobs in ONE int32 tensor [B, 2 + 2*n_top]:
    col 0 token id, col 1 logprob float32 bits, then the top-n ids and
    their logprob bits -- one device-to-host copy per step."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    tok = tokens.clamp(0, logits.shape[-1] - 1).long()
    lp = torch.gather(logits, 1, tok[:, None])[:, 0] - lse
    parts = [tokens.to(torch.int32)[:, None], lp.view(torch.int32)[:, None]]
    if n_top > 0:
        top_vals, top_ids = torch.topk(logits, n_top, dim=-1)
        parts += [top_ids.to(torch.int32),
                  (top_vals - lse[:, None]).contiguous().view(torch.int32)]
    return torch.cat(parts, dim=1)


def unpack_samples(samples: np.ndarray, n_top: int = 0):
    """Host-side inverse of pack_samples: (tokens [B], logprobs [B],
    top_ids [B, n], top_lps [B, n]) as numpy arrays."""
    samples = np.asarray(samples)
    tokens = samples[:, 0]
    lps = samples[:, 1].view(np.float32)
    if n_top > 0:
        top_ids = samples[:, 2:2 + n_top]
        top_lps = np.ascontiguousarray(
            samples[:, 2 + n_top:2 + 2 * n_top]).view(np.float32)
    else:
        top_ids = top_lps = None
    return tokens, lps, top_ids, top_lps
