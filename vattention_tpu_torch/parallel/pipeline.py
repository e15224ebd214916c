"""Pipeline parallelism: a step's microbatches through this rank's stage.

Counterpart of ``vattention_tpu/parallel/pipeline.py``.  The JAX package
compiles a GPipe rotation into one SPMD program: microbatch m occupies
stage s at tick m + s and the activations move with ``ppermute``.  The
port runs one process per rank, so the rotation is the order itself:
each stage takes the step's M microbatches in turn, receives each from
the previous stage (stage 0 embeds its tokens instead), runs it through
the stage's layers and sends it on; the last stage computes the head of
each.  Stage s works on microbatch m while stage s + 1 works on m - 1, as
in the JAX rotation, because a send returns once its data has gone.

The decode batch is split into M equal groups of slots
(``split_microbatches``).  A step with a prefill region is split by
position (``split_mixed_microbatches``): the region is cut into M
contiguous sub-chunks of whole q tiles, each with an equal share of the
decode slots, and causality makes the GPipe order correct: sub-chunk
m + 1 reaches a stage only after sub-chunk m has appended its K/V there.
The JAX step also carries the prefill's append runs, which the host
splits at the sub-chunk edges; the port appends by ``append_rows`` (kernel
A), so a sub-chunk's token window carries its own rows and nothing is
split on the host.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from vattention_tpu_torch.model_executor.step_inputs import StepInputs


def _aligned(x: torch.Tensor) -> torch.Tensor:
    # the kernels read 16-byte aligned tensors; microbatch m's slice of a
    # stacked tensor starts wherever m rows of the others end
    return x if x.data_ptr() % 16 == 0 else x.clone()


def microbatch(stacked: StepInputs, m: int) -> StepInputs:
    """Microbatch ``m`` of a stacked StepInputs, each tensor 16-byte
    aligned."""
    return stacked._replace(**{
        k: _aligned(getattr(stacked, k)[m]) for k in StepInputs._fields
        if k != "pod" and getattr(stacked, k) is not None})


def _bcast(x: Optional[torch.Tensor], M: int) -> Optional[torch.Tensor]:
    return None if x is None else x.expand((M,) + tuple(x.shape))


def split_microbatches(inputs: StepInputs, num_micro: int,
                       n_pre: int) -> StepInputs:
    """Stack a decode-only StepInputs into [M, ...] microbatches.

    The B decode slots are split contiguously; slot-indexed tensors keep
    their position inside their microbatch (the kernels see B/M slots).
    The previous step's tokens must already be spliced in
    (``use_prev_tok`` is dropped), as the JAX step splices before it
    splits.
    """
    if n_pre != 0:
        raise ValueError("split_microbatches takes decode-only steps")
    B = inputs.dec_seqlens.shape[0]
    if B % num_micro:
        raise ValueError(f"{B} slots do not split into {num_micro}")
    Bm = B // num_micro

    def split_slot(x):  # [B, ...] -> [M, Bm, ...]
        return None if x is None else x.reshape((num_micro, Bm)
                                                + tuple(x.shape[1:]))

    si = inputs.sample_idx
    return inputs._replace(
        token_ids=split_slot(inputs.token_ids),
        positions=split_slot(inputs.positions),
        append_rows=split_slot(inputs.append_rows),
        dec_seqlens=split_slot(inputs.dec_seqlens),
        dec_tile_rows=split_slot(inputs.dec_tile_rows),
        sample_idx=split_slot(torch.where(si >= 0, si % max(Bm, 1),
                                          torch.full_like(si, -1))),
        temperatures=split_slot(inputs.temperatures),
        top_p=split_slot(inputs.top_p),
        top_k=split_slot(inputs.top_k),
        pre_qinfo=_bcast(inputs.pre_qinfo, num_micro),
        qt_run=None, pre_tile_rows=None, pre_block_tables=None,
        use_prev_tok=None, pod=False)


def split_mixed_microbatches(inputs: StepInputs, num_micro: int, n_pre: int,
                             q_tile: int) -> Tuple[StepInputs, torch.Tensor]:
    """Stack a mixed (prefill + decode) StepInputs into [M, ...]
    microbatches by position.

    The prefill region is cut into M contiguous sub-chunks of W = n_pre / M
    tokens and the B decode slots into M groups of B / M; a microbatch's
    tokens are [W prefill rows | B/M decode rows].  Returns ``(stacked,
    m_sel)``: ``m_sel [B]`` is the microbatch whose head output carries
    each slot's sampled logits, and each microbatch's ``sample_idx`` is
    [B] (slot-aligned, -1 where another microbatch samples the slot).
    """
    M = num_micro
    W = n_pre // M
    B = inputs.dec_seqlens.shape[0]
    Bm = B // M
    if n_pre % M or W % q_tile or B % M:
        raise ValueError(f"n_pre {n_pre}, {B} slots: no split into {M} "
                         f"microbatches of whole {q_tile}-token q tiles")

    def split_tok(x):  # [n_pre + B, ...] -> [M, W + Bm, ...]
        rest = tuple(x.shape[1:])
        pre = x[:n_pre].reshape((M, W) + rest)
        dec = x[n_pre:].reshape((M, Bm) + rest)
        return torch.cat([pre, dec], dim=1)

    def split_slot(x):  # [B, ...] -> [M, Bm, ...]
        return None if x is None else x.reshape((M, Bm) + tuple(x.shape[1:]))

    si = inputs.sample_idx
    is_pre = (si >= 0) & (si < n_pre)
    is_dec = si >= n_pre
    zero = torch.zeros_like(si)
    m_sel = torch.where(is_pre, si // W,
                        torch.where(is_dec, (si - n_pre) // Bm, zero))
    loc = torch.where(is_pre, si % W,
                      torch.where(is_dec, W + (si - n_pre) % Bm,
                                  torch.full_like(si, -1)))
    mm = torch.arange(M, dtype=si.dtype, device=si.device)
    sample_m = torch.where(m_sel[None, :] == mm[:, None], loc[None, :],
                           torch.full_like(loc[None, :], -1))
    stacked = inputs._replace(
        token_ids=split_tok(inputs.token_ids),
        positions=split_tok(inputs.positions),
        append_rows=split_tok(inputs.append_rows),
        dec_seqlens=split_slot(inputs.dec_seqlens),
        dec_tile_rows=split_slot(inputs.dec_tile_rows),
        sample_idx=sample_m,
        temperatures=split_slot(inputs.temperatures),
        top_p=split_slot(inputs.top_p),
        top_k=split_slot(inputs.top_k),
        pre_qinfo=_bcast(inputs.pre_qinfo, M),
        qt_run=inputs.qt_run.reshape(M, W // q_tile, 2),
        pre_tile_rows=_bcast(inputs.pre_tile_rows, M),
        pre_block_tables=_bcast(inputs.pre_block_tables, M),
        use_prev_tok=None, pod=False)
    return stacked, m_sel.to(torch.int64)


def pipeline_stage_step(model, backend, params, kv_cache: torch.Tensor,
                        stacked: StepInputs, *, n_pre: int, num_micro: int,
                        mesh) -> Optional[List[torch.Tensor]]:
    """This rank's part of a step: its stage's layers over the ``num_micro``
    microbatches of ``stacked`` (each ``n_pre`` prefill tokens wide), in
    order.  Returns each microbatch's logits on the sampling rank (the
    head is computed there only), None on every other rank.  The arena
    holds the stage's layers and is updated in place."""
    logits = [] if mesh.is_sampling_rank else None
    H = model.arch.hidden_size
    for m in range(num_micro):
        inp = microbatch(stacked, m)
        if mesh.is_first_stage:
            x = model.embed(params, inp.token_ids)
        else:
            x = mesh.recv_prev((inp.token_ids.shape[0], H), model.dtype)
        if not mesh.is_last_stage:
            mesh.send_next(model.run_layers(params, kv_cache, x, inp,
                                            backend, n_pre))
            continue
        # the last stage adds its last MLP output inside the final norm
        x, tail = model.run_layers(params, kv_cache, x, inp, backend, n_pre,
                                   carry=True)
        if logits is not None:
            logits.append(model.head(params, x, inp.sample_idx, tail))
    return logits
