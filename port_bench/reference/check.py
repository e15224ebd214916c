"""The comparison that decides ``correct`` for a served model.

For each sampled finished request the reference runs once over its prompt
and served tokens and gives the logits at the positions that produced
them.  Two numbers are read over every served token of the sample:

- ``gap``: the widest gap by which a served token's reference logit lies
  below the reference's best logit at that position (greedy traffic: 0
  where the program picked the reference's choice);
- ``lp_err``: the widest difference between the logprob the program
  returned with the token (computed from the logits of the timed step)
  and the reference's logprob of the same token;
- ``lp_err_mean``: the mean of that difference over every served token
  of the sample, steadier from seed to seed than the widest.

A cell compares the numbers it gives a limit for.  The forward itself is
``reference/<model_type>.py``'s ``Reference(config, weights)`` with
``logits(ids, rows)``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence

import torch

NUMBERS = ("gap", "lp_err", "lp_err_mean")


@dataclass
class Served:
    """One finished request as the program served it."""
    prompt: List[int]
    tokens: List[int]
    logprobs: List[float]


def allow_tf32(on: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def read(ref, served: Served, device) -> Dict[str, float]:
    """{"gap": ..., "lp_err": ..., "lp_sum": ..., "tokens": n} of one
    request."""
    n = len(served.tokens)
    ids = served.prompt + served.tokens[:-1]
    P = len(served.prompt)
    logits = ref.logits(ids, range(P - 1, P - 1 + n))
    tok = torch.as_tensor(served.tokens, dtype=torch.long,
                          device=logits.device)
    picked = logits.gather(1, tok[:, None])[:, 0]
    gap = logits.max(dim=1).values - picked
    lp_ref = picked - torch.logsumexp(logits, dim=1)
    lp_prog = torch.as_tensor(served.logprobs, dtype=torch.float32,
                              device=logits.device)
    err = (lp_prog - lp_ref).abs()
    return {"gap": float(gap.max()), "lp_err": float(err.max()),
            "lp_sum": float(err.double().sum()), "tokens": n}


def combine(readings: Sequence[Dict[str, float]]) -> Dict[str, float]:
    """The widest of each number over the requests, and the tokens
    compared."""
    if not readings:
        return {}
    out = {k: max(r[k] for r in readings) for k in ("gap", "lp_err")}
    out["tokens"] = sum(r["tokens"] for r in readings)
    out["lp_err_mean"] = sum(r["lp_sum"] for r in readings) / out["tokens"]
    return out


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """True when every number given a limit is within it (a missing
    number, or a number that is not finite, fails)."""
    for k in limits:
        v = numbers.get(k)
        if v is None or not (v == v) or v == float("inf") or v > limits[k]:
            return False
    return True
