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
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch


class StepInputs(NamedTuple):
    token_ids: torch.Tensor      # [T] int64
    positions: torch.Tensor      # [T] int32
    append_rows: torch.Tensor    # [T] int32 arena row per token (-1 = skip)
    dec_seqlens: torch.Tensor    # [B] int32 (0 = not decoding this step)
    dec_tile_rows: Optional[torch.Tensor]  # [B, n_sub] int32 (None: no_op)
    sample_idx: torch.Tensor     # [B] int64 index into [T] (-1 = none)
    temperatures: torch.Tensor   # [B] float32
    top_p: torch.Tensor          # [B] float32
    top_k: torch.Tensor          # [B] int32
    # prefill metadata; None on decode-only steps
    pre_qinfo: Optional[torch.Tensor] = None      # [K+1, 2] (q_start, kv_len)
    qt_run: Optional[torch.Tensor] = None         # [n_pre//q_tile, 2]
    pre_tile_rows: Optional[torch.Tensor] = None  # [K+1, n_sub] int32
    # paged only: [K+1, NB] int32 block ids of each run
    pre_block_tables: Optional[torch.Tensor] = None
    # POD only (host-side, set by the runner): this step has both prefill
    # runs and decode slots, so attention runs fused (kernel F)
    pod: bool = False

    @classmethod
    def from_host(cls, device: torch.device, *, pod: bool = False,
                  **arrays) -> "StepInputs":
        """Move numpy arrays to ``device``: the int32 ones as ONE packed
        host-to-device copy, split into views on the device (each view
        starts 16-byte aligned, as the kernel wrappers require)."""
        ints = {k: np.ascontiguousarray(a, np.int32)
                for k, a in arrays.items()
                if a is not None and a.dtype != np.float32}
        floats = {k: a for k, a in arrays.items()
                  if a is not None and a.dtype == np.float32}
        offs, total = {}, 0
        for k, a in ints.items():
            offs[k] = total
            total += -(-a.size // 4) * 4
        flat = np.zeros(total, np.int32)
        for k, a in ints.items():
            flat[offs[k]:offs[k] + a.size] = a.reshape(-1)
        flat = torch.from_numpy(flat).to(device)
        out = {k: flat[offs[k]:offs[k] + a.size].view(a.shape)
               for k, a in ints.items()}
        for k, a in floats.items():
            out[k] = torch.from_numpy(a).to(device)
        out["token_ids"] = out["token_ids"].long()
        out["sample_idx"] = out["sample_idx"].long()
        for k in cls._fields:
            out.setdefault(k, None)
        out["pod"] = pod
        return cls(**out)
