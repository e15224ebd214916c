"""StepInputs: the per-step tensors handed to the serving step.

Counterpart of ``vattention_tpu/model_executor/step_inputs.py``.  The
token layout is the same (prefills before decodes, decode tokens
slot-indexed):

    [0, n_prefill_tokens)            up to K sequences' prompt chunks,
                                     each padded to the q tile
    [n_prefill_tokens, n_pre + B)    one decode token per batch SLOT
                                     (slot b at index n_pre + b)

The kernels read host-resolved arena-row tables (``pre_tile_rows``,
``dec_tile_rows``) rather than the extent tables themselves, so the
segment tables and the prefill run table of the JAX step are not carried.
The paged engine's prefill kernel reads the runs' block tables
(``pre_block_tables``, the JAX step's ``pre_seg_row``) instead of
``pre_tile_rows``; its ``dec_tile_rows`` are its block tables times the
block size, each entry clamped to the slot's last valid block.

``InputStager`` moves a step's host arrays to the device.  The JAX runner
hands XLA fresh arrays each step; a captured CUDA graph reads fixed
addresses instead, so the stager keeps one persistent device buffer per
layout (the arrays' names and shapes, which the step's signature fixes)
and every step's tensors are views of it.  The arrays go through a ring
of pinned host buffers, one ``non_blocking`` copy per step; each buffer
is guarded by an event recorded after its copy, so the host never
overwrites a buffer the device has not read yet.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch


class StepInputs(NamedTuple):
    token_ids: torch.Tensor      # [T] int32 (or int64)
    positions: torch.Tensor      # [T] int32
    append_rows: torch.Tensor    # [T] int32 arena row per token (-1 = skip)
    dec_seqlens: torch.Tensor    # [B] int32 (0 = not decoding this step)
    dec_tile_rows: Optional[torch.Tensor]  # [B, n_sub] int32 (None: no_op)
    sample_idx: torch.Tensor     # [B] int32 index into [T] (-1 = none)
    temperatures: torch.Tensor   # [B] float32
    top_p: torch.Tensor          # [B] float32
    top_k: torch.Tensor          # [B] int32
    # prefill metadata; None on decode-only steps
    pre_qinfo: Optional[torch.Tensor] = None      # [K+1, 2] (q_start, kv_len)
    qt_run: Optional[torch.Tensor] = None         # [n_pre//q_tile, 2]
    pre_tile_rows: Optional[torch.Tensor] = None  # [K+1, n_sub] int32
    # paged only: [K+1, NB] int32 block ids of each run
    pre_block_tables: Optional[torch.Tensor] = None
    # async execution: slots whose input token is the previous step's
    # sample, still on the device (1) -- the step splices it in from the
    # runner's token buffer ([B] int32; None: no slot waits)
    use_prev_tok: Optional[torch.Tensor] = None
    # POD only (host-side, set by the runner): this step has both prefill
    # runs and decode slots, so attention runs fused (kernel F)
    pod: bool = False


class InputStager:
    """Host arrays -> ``StepInputs`` on ``device`` through persistent
    buffers (see the module docstring).  ``ring`` host buffers: the
    runner's ``max_inflight_steps + 1``."""

    def __init__(self, device: torch.device, ring: int):
        self.device = device
        self._pinned = device.type == "cuda"
        self._host: List[Optional[torch.Tensor]] = [None] * ring
        self._events: List[Optional[torch.cuda.Event]] = [None] * ring
        self._next = 0
        # layout -> (device buffer, views by name)
        self._layouts: Dict[tuple, tuple] = {}

    def stage(self, *, pod: bool = False, **arrays) -> StepInputs:
        """``arrays``: StepInputs fields as numpy arrays (None: absent);
        float32 arrays travel as their bits in the one int32 copy."""
        arrays = {k: a for k, a in arrays.items() if a is not None}
        key = tuple((k, a.shape) for k, a in arrays.items())
        layout = self._layouts.get(key)
        if layout is None:
            layout = self._layouts[key] = self._new_layout(arrays)
        dev_buf, offsets, views = layout
        total = dev_buf.numel()

        slot = self._next
        self._next = (slot + 1) % len(self._host)
        if self._events[slot] is not None:
            # the copy of ``ring`` steps ago; the in-flight bound means the
            # device finished that step already, so this does not block
            self._events[slot].synchronize()
        host = self._host[slot]
        if host is None or host.numel() < total:
            host = self._host[slot] = torch.empty(
                total, dtype=torch.int32, pin_memory=self._pinned)
        flat = host.numpy()
        for k, a in arrays.items():
            a = np.ascontiguousarray(a)
            bits = (a.view(np.int32) if a.dtype == np.float32
                    else a.astype(np.int32, copy=False))
            flat[offsets[k]:offsets[k] + a.size] = bits.reshape(-1)
        dev_buf.copy_(host[:total], non_blocking=True)
        if self._pinned:
            event = torch.cuda.Event()
            event.record()
            self._events[slot] = event
        return StepInputs(**views, pod=pod)

    def _new_layout(self, arrays) -> tuple:
        offsets, total = {}, 0
        for k, a in arrays.items():
            offsets[k] = total
            total += -(-a.size // 4) * 4  # each view 16-byte aligned
        dev_buf = torch.zeros(max(total, 4), dtype=torch.int32,
                              device=self.device)
        views = {k: None for k in StepInputs._fields if k != "pod"}
        for k, a in arrays.items():
            v = dev_buf[offsets[k]:offsets[k] + a.size].view(a.shape)
            views[k] = v.view(torch.float32) if a.dtype == np.float32 else v
        return dev_buf, offsets, views

    def cleanup(self) -> None:
        self._layouts.clear()
        self._host = [None] * len(self._host)
        self._events = [None] * len(self._events)
