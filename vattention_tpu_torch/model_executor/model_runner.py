"""ModelRunner: input preparation + the serving step.

Counterpart of ``vattention_tpu/model_executor/model_runner.py``.
``_prepare_inputs`` builds the same fixed-layout numpy arrays as the JAX
runner (prefill runs padded to the q tile and the region padded to one
fixed width, tail tiles mapped to an empty run; decode tokens
slot-indexed) and moves them to the device in one packed copy.  ``_step``
is eager PyTorch: embed -> a Python loop over layers (one launch per layer
and op, the attention ops being the port's CUDA kernels) -> sampler.
The step is synchronous: ``run`` returns this step's sampled tokens.
"""

from __future__ import annotations

import time
from typing import List

import numpy as np
import torch

from vattention_tpu_torch.config import PREFILL_TOKEN_PAD, SystemConfig
from vattention_tpu_torch.core.datatypes.sequence import (
    SamplerOutput, SamplerOutputs, SequenceMetadata)
from vattention_tpu_torch.logger import init_logger
from vattention_tpu_torch.metrics.constants import CpuOperationMetrics
from vattention_tpu_torch.metrics.metrics_store import MetricsStore
from vattention_tpu_torch.model_executor.attention.vattn_backend import (
    VattnAttentionBackend)
from vattention_tpu_torch.model_executor.layers.sampler import (
    pack_samples, sample_tokens, unpack_samples)
from vattention_tpu_torch.model_executor.models import get_model_class
from vattention_tpu_torch.model_executor.step_inputs import StepInputs
from vattention_tpu_torch.model_executor.weight_utils import load_weights
from vattention_tpu_torch.ops.utils import round_up, tile_rows_from_segments

logger = init_logger(__name__)

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class ModelRunner:
    def __init__(self, config: SystemConfig, cache_engine,
                 device: torch.device, *, seed: int = 0):
        self.config = config
        self.cache_engine = cache_engine
        self.device = device
        if device.type == "cuda":
            # float32 runs are exact float32: no TF32 in matmuls
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        arch = config.model_config.arch
        self.model = get_model_class(arch.model_type)(
            arch, dtype=DTYPES[config.model_config.dtype])
        self.params = load_weights(self.model, config.model_config, device,
                                   seed=seed)
        # the scheduler's charge unit is also the prefill pad unit
        self.q_tile = PREFILL_TOKEN_PAD
        self.max_prefills = getattr(
            config.scheduler_config, "max_prefills_per_step", 4)
        # fixed prefill-region width: chunked schedulers charge prefills in
        # q-tile units, so padded runs always fit it
        self.n_pre_fixed = round_up(
            config.scheduler_config.get_max_num_batched_tokens(
                config.model_config.max_model_len), self.q_tile)
        self.B = config.cache_config.max_batch_size
        self.backend = VattnAttentionBackend(
            block_tokens=cache_engine.block_tokens,
            max_context_len=config.model_config.max_model_len,
            arena_rows=cache_engine.allocator.arena_tokens,
            q_tile=self.q_tile)
        self.logprobs_top = config.model_config.max_logprobs
        self._metrics_store = MetricsStore.get_instance()
        self._generator = torch.Generator(device=device).manual_seed(seed)

    # ------------------------------------------------------------------ #
    def _step(self, inputs: StepInputs, n_pre: int) -> torch.Tensor:
        logits = self.model.forward(self.params, self.cache_engine.kv_cache,
                                    inputs, self.backend, n_pre)
        tokens = sample_tokens(logits, inputs.temperatures, inputs.top_p,
                               inputs.top_k, self._generator)
        tokens = torch.where(inputs.sample_idx >= 0, tokens,
                             torch.full_like(tokens, -1))
        return pack_samples(logits, tokens, self.logprobs_top)

    # ------------------------------------------------------------------ #
    def _prepare_inputs(self, seq_metadata_list: List[SequenceMetadata]):
        ce = self.cache_engine
        prefills = [m for m in seq_metadata_list if m.is_prompt]
        decodes = [m for m in seq_metadata_list if not m.is_prompt]
        K_max = self.max_prefills
        if len(prefills) > K_max:
            raise ValueError(
                f"{len(prefills)} prefill runs > max_prefills_per_step "
                f"{K_max} (scheduler contract)")

        # each prefill run padded to the q tile; runs concatenated; the
        # region padded to one fixed width (a doubling ladder for
        # whole-prompt schedulers).  Tail q tiles map to the empty run
        # K_max, whose kv_len 0 makes the prefill kernel write zeros.
        chunks = [m.prompt_chunk_len for m in prefills]
        pads = [round_up(max(c, 1), self.q_tile) for c in chunks]
        run_offs = np.concatenate([[0], np.cumsum(pads)]).astype(np.int64)
        n_pre = int(run_offs[-1])
        if prefills:
            fixed = self.n_pre_fixed
            while fixed < n_pre:
                fixed *= 2
            n_pre = fixed
        B = self.B
        T = n_pre + B

        token_ids = np.zeros(T, np.int32)
        positions = np.zeros(T, np.int32)
        append_rows = np.full(T, -1, np.int32)
        pre_seg_row = np.zeros((K_max + 1, ce.table_width), np.int32)
        pre_seg_cum = np.zeros((K_max + 1, ce.table_width + 1), np.int32)
        pre_qinfo = np.zeros((K_max + 1, 2), np.int32)
        qt_run = np.zeros((n_pre // self.q_tile, 2), np.int32)
        qt_run[:, 0] = K_max  # default: the empty run
        dec_seqlens = np.zeros(B, np.int32)
        sample_idx = np.full(B, -1, np.int32)
        temperatures = np.ones(B, np.float32)
        top_p = np.ones(B, np.float32)
        top_k = np.full(B, -1, np.int32)

        seg_row_all, seg_tok_all = ce.get_batch_segments()
        for i, meta in enumerate(prefills):
            chunk = chunks[i]
            off = int(run_offs[i])
            seq = meta.seq
            slot = ce.slot_of(meta.seq_id)
            processed = seq.get_num_prompt_tokens_processed()
            token_ids[off:off + chunk] = seq.get_next_prompt_chunk_token_ids(
                chunk)
            positions[off:off + chunk] = np.arange(processed,
                                                   processed + chunk)
            append_rows[off:off + chunk] = ce.get_slot_rows(
                slot, processed, chunk)
            pre_seg_row[i] = seg_row_all[slot]
            pre_seg_cum[i, 1:] = np.cumsum(seg_tok_all[slot])
            pre_qinfo[i] = (processed, processed + chunk)
            for lqt in range(pads[i] // self.q_tile):
                qt_run[off // self.q_tile + lqt] = (i, lqt)
            if processed + chunk == seq.get_prompt_len():
                sample_idx[slot] = off + chunk - 1
                sp = seq.sampling_params
                temperatures[slot] = sp.temperature
                top_p[slot] = sp.top_p
                top_k[slot] = sp.top_k

        dec_seg_cum = np.zeros((B, ce.table_width + 1), np.int32)
        dec_seg_cum[:, 1:] = np.cumsum(seg_tok_all, axis=1)
        be = self.backend
        dec_tile_rows = tile_rows_from_segments(
            seg_row_all, dec_seg_cum, be.sub, be.n_sub)
        pre_tile_rows = (tile_rows_from_segments(
            pre_seg_row, pre_seg_cum, be.sub, be.n_sub) if prefills else None)

        for meta in decodes:
            seq = meta.seq
            slot = ce.slot_of(meta.seq_id)
            t = n_pre + slot
            token_ids[t] = seq.get_last_token_id()
            pos = seq.get_len() - 1
            positions[t] = pos
            append_rows[t] = ce.get_slot_rows(slot, pos, 1)[0]
            dec_seqlens[slot] = seq.get_len()
            sample_idx[slot] = t
            sp = seq.sampling_params
            temperatures[slot] = sp.temperature
            top_p[slot] = sp.top_p
            top_k[slot] = sp.top_k

        inputs = StepInputs.from_host(
            self.device, token_ids=token_ids, positions=positions,
            append_rows=append_rows, dec_seqlens=dec_seqlens,
            dec_tile_rows=dec_tile_rows, sample_idx=sample_idx,
            temperatures=temperatures, top_p=top_p, top_k=top_k,
            pre_qinfo=pre_qinfo if prefills else None,
            qt_run=qt_run if prefills else None,
            pre_tile_rows=pre_tile_rows)
        return inputs, n_pre

    # ------------------------------------------------------------------ #
    def run(self, seq_metadata_list: List[SequenceMetadata]
            ) -> SamplerOutputs:
        """One synchronous serving step: returns this step's samples."""
        if not seq_metadata_list:
            return []
        t0 = time.perf_counter()
        inputs, n_pre = self._prepare_inputs(seq_metadata_list)
        self._metrics_store.push_cpu_operation_time(
            CpuOperationMetrics.PREPARE_INPUTS, time.perf_counter() - t0)
        samples = self._step(inputs, n_pre).cpu().numpy()
        tokens, lps, top_ids, top_lps = unpack_samples(samples,
                                                       self.logprobs_top)
        ce = self.cache_engine
        outputs = []
        for meta in seq_metadata_list:
            seq = meta.seq
            if meta.is_prompt:
                processed = seq.get_num_prompt_tokens_processed()
                if processed + meta.prompt_chunk_len < seq.get_prompt_len():
                    continue  # mid-prompt chunk: nothing sampled
            slot = ce.slot_of(meta.seq_id)
            outputs.append(SamplerOutput(
                seq.seq_id, int(tokens[slot]), logprob=float(lps[slot]),
                top_logprobs=(
                    None if top_ids is None else
                    [(int(i), float(p)) for i, p in
                     zip(top_ids[slot], top_lps[slot])])))
        return outputs
