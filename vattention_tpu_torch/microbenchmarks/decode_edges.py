"""Edge cases of kernel C's body (kernels C and F's decode role) on the
card, held against the plain version: the counterpart of
``prefill_edges.py`` for decode.

One batch of slots whose depths reach the body's tile (64 positions) and
split edges: 1, 63, 64, 65, 255, 256, 257 and 4133; two idle slots, which
must be exactly zero; and two shallow slots (5 and 100 positions) whose
tables are 32768 positions deep, as deep as every other slot's.  Each
slot's table is a seeded permutation of the arena's blocks.  The batch runs
at ``sub`` 256 and 16 (the arena's tiles and vLLM's block) and at group
sizes G = 1, 2, 4 and 8 (each a chunk width of the body) and 71
(Falcon-7B's: 9 chunks, the last one partial), Hq = G * Hkv query heads.
With a sliding ``window`` the kernel and the plain version take it, and
slots at depths ``window - 1``, ``window``, ``window + 1``, ``window + 64``
and ``3 * window + 100`` join the batch: the first tile a slot walks, and
the one position of it that is masked, move with the depth.

``check_decode_edges`` raises on the first failure.
"""

from __future__ import annotations

import numpy as np
import torch

from vattention_tpu_torch.microbenchmarks.timing import check_attention
from vattention_tpu_torch.ops.flash_decode import (decode_attention,
                                                   decode_attention_plain)

EDGE_DEPTHS = [1, 63, 64, 65, 255, 256, 257, 0, 4133, 0, 5, 100]
TABLE_DEPTH = 32768
SUBS = (256, 16)
EDGE_GROUPS = (1, 2, 4, 8, 71)


def edge_depths(window=None):
    """The batch's depths under ``window`` (None: none)."""
    if not window:
        return list(EDGE_DEPTHS)
    extra = [window - 1, window, window + 1, window + 64, 3 * window + 100]
    return EDGE_DEPTHS + [d for d in extra if d <= TABLE_DEPTH]


def check_decode_edges(cache: torch.Tensor, layer: int, seed: int = 0,
                       sm_scale: float | None = None, out_scale: float = 1.0,
                       window=None):
    """The cases above over ``cache`` ([L, 2, Hkv, R, D] on the card, R >=
    TABLE_DEPTH; a 1-byte arena is read by bf16 queries; an int8 arena's
    step goes in ``sm_scale`` and ``out_scale``) under ``window`` (None:
    none).  Raises on the first failure; returns (max abs err against the
    plain version, the worst slot's err as a fraction of its largest
    output)."""
    dev = cache.device
    Hkv, R, D = cache.shape[2], cache.shape[3], cache.shape[4]
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    depths = edge_depths(window)
    seqlens = torch.tensor(depths, dtype=torch.int32, device=dev)
    qdt = torch.bfloat16 if cache.element_size() == 1 else cache.dtype
    sm = D ** -0.5 if sm_scale is None else sm_scale
    err, rel = 0.0, 0.0
    for sub in SUBS:
        width = TABLE_DEPTH // sub
        rows = np.stack([rng.permutation(R // sub)[:width] * sub
                         for _ in depths]).astype(np.int32)
        tile_rows = torch.from_numpy(rows).to(dev)
        for g in EDGE_GROUPS:
            q = torch.randn((len(depths), g * Hkv, D), generator=gen,
                            device=dev).to(qdt)
            args = (q, cache, tile_rows, seqlens, layer)
            kw = dict(sub=sub, sm_scale=sm, window=window)
            got = decode_attention(*args, **kw)
            ref = decode_attention_plain(*args, **kw)
            torch.cuda.synchronize()
            if not torch.isfinite(got).all():
                raise AssertionError(f"decode edges sub {sub} G {g}: "
                                     "non-finite output")
            for b, n in enumerate(depths):
                if n == 0:
                    if got[b].abs().max().item() != 0.0:
                        raise AssertionError(
                            f"decode edges sub {sub} G {g}: idle slot {b} "
                            "is not zero")
                    continue
                e, r = check_attention(
                    f"decode edges sub {sub} G {g}, slot {b} at depth {n}",
                    got[b:b + 1], ref[b:b + 1], scale=out_scale)
                err, rel = max(err, e), max(rel, r)
    return err, rel
