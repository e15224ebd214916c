"""ModelRunner: input preparation + the serving step.

Counterpart of ``vattention_tpu/model_executor/model_runner.py``.
``_prepare_inputs`` builds the same fixed-layout numpy arrays as the JAX
runner (prefill runs padded to the q tile and the region padded to one
fixed width, tail tiles mapped to an empty run; decode tokens
slot-indexed) and stages them in the device's persistent input buffers
(``step_inputs.InputStager``: one copy per step).  The backend follows
the cache engine as in the JAX runner: ``no_op`` skips attention, the
vattn arena reads row tables, the paged pool block tables, and the POD
backends the arena's tables through kernel F on steps that mix prefills
and decodes.

``_step`` is the JAX runner's jitted ``_step``: splice the previous
step's tokens in from the device token buffer, embed -> the layers (the
attention ops being the port's CUDA kernels) -> head -> sampler -> token
buffer update -> ``pack_samples``.  On a CUDA device it runs as one CUDA
graph per step signature (``n_pre``, the POD flag, the sampler mode: the
JAX step's static arguments).  The first step of a signature runs
eagerly, which builds the kernels, copies the rope's frequencies and
sizes the decode scratch, and is then captured; every later step of that
signature replays its graph.  The graphs share one memory pool; the arena
and the token buffer are updated in place, as JAX donates them.  A capture
that fails raises.  On the CPU the step runs eagerly.

Under tensor and pipeline parallelism (a ``parallel.mesh.ServingMesh``)
the runner is one rank's, and ``_step`` is the JAX ``_step_parallel``: the
step is cut into M microbatches (M = pp for decode-only steps, and for
mixed steps whose prefill region splits into pp sub-chunks of whole q
tiles on a backend other than POD; else M = 1, as the JAX runner
chooses), this rank's stage runs them (``parallel.pipeline``), the last
stage's tp-rank 0 computes the logits and samples, and the packed samples
are broadcast to every rank, whose token buffers and host bookkeeping all
read the same tokens.  The prefill region's width is rounded up to pp q
tiles.  Under nccl a step signature is captured as one CUDA graph,
collectives included; under gloo, whose collectives the host drives,
every step runs eagerly.

``run_async`` dispatches a step and returns a ``StepHandle`` at once: the
samples are copied to pinned host memory behind the step and an event
marks their arrival; ``resolve`` waits for that event and reads them.
``run`` is ``resolve(run_async(...))``.
"""

from __future__ import annotations

import time
from typing import Dict, List, NamedTuple

import numpy as np
import torch

from vattention_tpu_torch.config import PREFILL_TOKEN_PAD, SystemConfig
from vattention_tpu_torch.core.datatypes.sequence import (
    SamplerOutput, SamplerOutputs, SequenceMetadata)
from vattention_tpu_torch.logger import init_logger
from vattention_tpu_torch.metrics.metrics_store import MetricsStore
from vattention_tpu_torch.metrics.timer import LAUNCH, PREPARE, span
from vattention_tpu_torch.model_executor.attention import AttentionBackend
from vattention_tpu_torch.model_executor.attention.no_op_backend import (
    NoOpAttentionBackend)
from vattention_tpu_torch.model_executor.attention.paged_backend import (
    PagedAttentionBackend)
from vattention_tpu_torch.model_executor.attention.pod_backend import (
    PodAttentionBackend)
from vattention_tpu_torch.model_executor.attention.vattn_backend import (
    VattnAttentionBackend)
from vattention_tpu_torch.model_executor.layers.sampler import (
    GREEDY, pack_samples, sample_tokens, sampler_mode, unpack_samples)
from vattention_tpu_torch.model_executor.models import get_model_class
from vattention_tpu_torch.model_executor.step_inputs import (InputStager,
                                                             StepInputs)
from vattention_tpu_torch.model_executor.weight_utils import load_weights
from vattention_tpu_torch.ops.cuda_build import CudaKernel
from vattention_tpu_torch.ops.flash_decode import current_scratch
from vattention_tpu_torch.ops.paged_attention import paged_tile_rows
from vattention_tpu_torch.ops.utils import round_up, tile_rows_from_segments
from vattention_tpu_torch.parallel.pipeline import (pipeline_stage_step,
                                                    split_microbatches,
                                                    split_mixed_microbatches)

logger = init_logger(__name__)

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class StepHandle:
    """A dispatched serving step whose samples may not have reached the
    host yet (async execution)."""

    __slots__ = ("seq_metadata_list", "sampled", "samples", "n_top",
                 "event")

    def __init__(self, seq_metadata_list, sampled, samples, n_top=0,
                 event=None):
        self.seq_metadata_list = seq_metadata_list
        # [(seq, slot, generation-at-dispatch)] for every sampled token
        self.sampled = sampled
        # host int32 [B, 2+2*n_top]: packed tokens + logprobs
        # (layers/sampler.pack_samples), valid once ``event`` completes
        self.samples = samples
        self.n_top = n_top
        # recorded after the device-to-host copy (None on the CPU)
        self.event = event

    def is_ready(self) -> bool:
        return self.event is None or self.event.query()

    def wait(self) -> None:
        """Block until the samples are on the host."""
        if self.event is not None:
            self.event.synchronize()
            self.event = None


class StepGraph(NamedTuple):
    """One captured step signature."""
    graph: "torch.cuda.CUDAGraph"
    samples: torch.Tensor         # the graph's output, rewritten per replay
    launches: Dict[CudaKernel, int]  # kernel launches per replay
    capture_s: float              # host seconds the capture took
    scratch: object               # the decode scratch the graph reads
    inputs_at: int                # address of the staged inputs it reads


class ModelRunner:
    def __init__(self, config: SystemConfig, cache_engine,
                 device: torch.device, *, seed: int = 0, mesh=None):
        self.config = config
        self.cache_engine = cache_engine
        self.device = device
        self.mesh = mesh
        self.pp = 1 if mesh is None else mesh.pp_size
        if device.type == "cuda":
            # float32 runs are exact float32: no TF32 in matmuls
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        arch = config.model_config.arch
        self.model = get_model_class(arch.model_type)(
            arch, dtype=DTYPES[config.model_config.dtype], mesh=mesh)
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
                config.model_config.max_model_len), self.pp * self.q_tile)
        # a step may be captured unless gloo runs its collectives
        self.captures = device.type == "cuda" and (
            mesh is None or mesh.captures_steps)
        if mesh is not None and device.type == "cuda" and not self.captures:
            logger.info("backend %s: every step runs eagerly (its "
                        "collectives are driven from the host, which a CUDA "
                        "graph cannot hold)", mesh.backend)
        self.B = config.cache_config.max_batch_size
        backend = config.model_config.attention_backend
        if AttentionBackend.is_no_op(backend):
            self.backend = NoOpAttentionBackend()
        elif cache_engine.kind == "vattn":
            arena = (PodAttentionBackend if AttentionBackend.is_pod(backend)
                     else VattnAttentionBackend)
            self.backend = arena(
                block_tokens=cache_engine.block_tokens,
                max_context_len=config.model_config.max_model_len,
                arena_rows=cache_engine.allocator.arena_tokens,
                q_tile=self.q_tile, kv_scale=cache_engine.kv_scale,
                sliding_window=arch.sliding_window)
        else:
            # the window on the paged backend too (the JAX runner leaves
            # it out there: ROADMAP Queue 3)
            self.backend = PagedAttentionBackend(
                block_size=cache_engine.block_size, q_tile=self.q_tile,
                kv_scale=cache_engine.kv_scale,
                sliding_window=arch.sliding_window)
        self.logprobs_top = config.model_config.max_logprobs
        self._metrics_store = MetricsStore.get_instance()
        self._generator = torch.Generator(device=device).manual_seed(seed)
        # each slot's latest sampled token, on the device: the next decode
        # step reads it without a round trip through the host
        self._tok_buf = torch.full((self.B,), -1, dtype=torch.int32,
                                   device=device)
        self._stager = InputStager(device, config.max_inflight_steps + 1)
        self.graphs: Dict[tuple, StepGraph] = {}
        self._pool = None  # the graphs' shared memory pool

    # ------------------------------------------------------------------ #
    @staticmethod
    def _splice_prev_tokens(inputs: StepInputs, tok_buf: torch.Tensor,
                            n_pre: int) -> StepInputs:
        """Decode slots flagged ``use_prev_tok`` read their input token from
        the device buffer (the previous step's sample) instead of the host
        array."""
        if inputs.use_prev_tok is None:
            return inputs
        dec = inputs.token_ids[n_pre:]
        dec = torch.where(inputs.use_prev_tok != 0, tok_buf.to(dec.dtype),
                          dec)
        token_ids = (torch.cat([inputs.token_ids[:n_pre], dec])
                     if n_pre else dec)
        return inputs._replace(token_ids=token_ids)

    def _step(self, inputs: StepInputs, n_pre: int,
              mode: str = GREEDY) -> torch.Tensor:
        """The whole step on the device: [B, 2 + 2 * n_top] int32 samples;
        the arena and the token buffer are updated in place."""
        inputs = self._splice_prev_tokens(inputs, self._tok_buf, n_pre)
        if self.mesh is not None:
            return self._step_parallel(inputs, n_pre, mode)
        logits = self.model.forward(self.params, self.cache_engine.kv_cache,
                                    inputs, self.backend, n_pre)
        return self._sample(logits, inputs, mode)

    def _sample(self, logits: torch.Tensor, inputs: StepInputs,
                mode: str) -> torch.Tensor:
        tokens = sample_tokens(logits, inputs.temperatures, inputs.top_p,
                               inputs.top_k, mode, self._generator)
        tokens = torch.where(inputs.sample_idx >= 0, tokens,
                             torch.full_like(tokens, -1))
        self._tok_buf.copy_(torch.where(tokens >= 0, tokens, self._tok_buf))
        return pack_samples(logits, tokens, self.logprobs_top)

    def microbatches(self, inputs: StepInputs, n_pre: int):
        """(M, stacked inputs, m_sel, prefill tokens per microbatch) under
        the JAX runner's rule."""
        B, pp = self.B, self.pp
        if n_pre == 0 and pp > 1 and B % pp == 0:
            return pp, split_microbatches(inputs, pp, 0), None, 0
        if (n_pre > 0 and pp > 1 and B % pp == 0
                and n_pre % (pp * self.q_tile) == 0 and not inputs.pod):
            stacked, m_sel = split_mixed_microbatches(inputs, pp, n_pre,
                                                      self.q_tile)
            return pp, stacked, m_sel, n_pre // pp
        stacked = inputs._replace(**{
            k: getattr(inputs, k)[None] for k in StepInputs._fields
            if k != "pod" and getattr(inputs, k) is not None})
        return 1, stacked, None, n_pre

    def _step_parallel(self, inputs: StepInputs, n_pre: int,
                       mode: str) -> torch.Tensor:
        """This rank's part of a step; the packed samples on every rank (a
        host tensor when gloo stages them)."""
        mesh = self.mesh
        M, stacked, m_sel, n_pre_m = self.microbatches(inputs, n_pre)
        logits = pipeline_stage_step(
            self.model, self.backend, self.params,
            self.cache_engine.kv_cache, stacked, n_pre=n_pre_m,
            num_micro=M, mesh=mesh)
        width = 2 + 2 * self.logprobs_top
        if logits is None:
            samples = mesh.broadcast_samples(None, (self.B, width))
            tokens = samples[:, 0].to(self._tok_buf.device)
            self._tok_buf.copy_(torch.where(tokens >= 0, tokens,
                                            self._tok_buf))
            return samples
        if m_sel is not None:
            # each slot's logits from the microbatch that samples it
            logits = torch.stack(logits).gather(
                0, m_sel[None, :, None].expand(
                    1, self.B, logits[0].shape[-1]))[0]
        else:
            logits = torch.cat(logits)
        return mesh.broadcast_samples(self._sample(logits, inputs, mode),
                                      (self.B, width))

    @staticmethod
    def signature(inputs: StepInputs, n_pre: int, mode: str) -> tuple:
        return (n_pre, inputs.pod, mode)

    def _launch(self, inputs: StepInputs, n_pre: int,
                mode: str) -> torch.Tensor:
        """Run one step: eagerly on the CPU and under gloo; on CUDA
        otherwise, a replay of its signature's graph, or the eager warm-up
        and then the capture."""
        if not self.captures:
            return self._step(inputs, n_pre, mode)
        sig = self.signature(inputs, n_pre, mode)
        graph = self.graphs.get(sig)
        if graph is not None:
            # the graph reads the stager's buffer of the layout it was
            # captured on; a signature must not meet two layouts
            if inputs.token_ids.data_ptr() != graph.inputs_at:
                raise RuntimeError(
                    f"step signature {sig}: inputs staged in another "
                    "buffer than the one its graph reads")
            return self.replay(graph)
        samples = self._step(inputs, n_pre, mode)
        self.graphs[sig] = self._capture(inputs, n_pre, mode)
        return samples

    def _capture(self, inputs: StepInputs, n_pre: int,
                 mode: str) -> StepGraph:
        """Capture ``_step`` on the stager's buffers.  A capture runs
        nothing: the kernel calls it counted are taken back off and added
        at each replay instead."""
        t0 = time.perf_counter()
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        if mode != GREEDY:
            # each replay draws the generator's next numbers, as an eager
            # call would
            graph.register_generator_state(self._generator)
        before = {k: k.launches for k in CudaKernel.INSTANCES}
        with torch.cuda.graph(graph, pool=self._pool):
            samples = self._step(inputs, n_pre, mode)
        launches = {}
        for k, n in before.items():
            if k.launches != n:
                launches[k] = k.launches - n
                k.launches = n
        return StepGraph(graph, samples, launches,
                         time.perf_counter() - t0,
                         current_scratch(self.device),
                         inputs.token_ids.data_ptr())

    @staticmethod
    def replay(graph: StepGraph) -> torch.Tensor:
        graph.graph.replay()
        for k, n in graph.launches.items():
            k.launches += n
        return graph.samples

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
        # a slot that samples nothing is greedy, so that an all-greedy
        # batch takes the greedy mode whatever its idle slots (the JAX
        # runner's 1.0 made the sampler draw for them)
        temperatures = np.zeros(B, np.float32)
        top_p = np.ones(B, np.float32)
        top_k = np.full(B, -1, np.int32)
        use_prev_tok = np.zeros(B, np.int32)

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

        for meta in decodes:
            seq = meta.seq
            slot = ce.slot_of(meta.seq_id)
            t = n_pre + slot
            if seq.num_pending_tokens > 0:
                # async execution: the token is still on the device; the
                # step splices it in from the token buffer
                use_prev_tok[slot] = 1
            else:
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

        # the kernels' tables: arena rows of each sub-tile (vattn), or
        # block ids for prefill and clamped block rows for decode (paged)
        be = self.backend
        dec_tile_rows = pre_tile_rows = pre_block_tables = None
        if isinstance(be, VattnAttentionBackend):
            dec_seg_cum = np.zeros((B, ce.table_width + 1), np.int32)
            dec_seg_cum[:, 1:] = np.cumsum(seg_tok_all, axis=1)
            dec_tile_rows = tile_rows_from_segments(
                seg_row_all, dec_seg_cum, be.sub, be.n_sub)
            if prefills:
                pre_tile_rows = tile_rows_from_segments(
                    pre_seg_row, pre_seg_cum, be.sub, be.n_sub)
        elif isinstance(be, PagedAttentionBackend):
            dec_tile_rows = paged_tile_rows(
                torch.from_numpy(seg_row_all), torch.from_numpy(dec_seqlens),
                be.block_size).numpy()
            if prefills:
                pre_block_tables = pre_seg_row

        inputs = self._stager.stage(
            token_ids=token_ids, positions=positions,
            append_rows=append_rows, dec_seqlens=dec_seqlens,
            dec_tile_rows=dec_tile_rows, sample_idx=sample_idx,
            temperatures=temperatures, top_p=top_p, top_k=top_k,
            pre_qinfo=pre_qinfo if prefills else None,
            qt_run=qt_run if prefills else None,
            pre_tile_rows=pre_tile_rows, pre_block_tables=pre_block_tables,
            use_prev_tok=use_prev_tok,
            pod=(isinstance(be, PodAttentionBackend) and bool(prefills)
                 and bool(decodes)))
        mode = sampler_mode(temperatures, top_p, top_k,
                            self.model.arch.vocab_size)
        return inputs, n_pre, mode

    # ------------------------------------------------------------------ #
    def run_async(self, seq_metadata_list: List[SequenceMetadata]
                  ) -> StepHandle:
        """Dispatch one serving step without waiting for its results.

        The sampled tokens stay on the device (the next step reads them
        from the token buffer) and are copied to pinned host memory behind
        the step, so ``resolve`` later finds them there."""
        with span(self._metrics_store, PREPARE):
            inputs, n_pre, mode = self._prepare_inputs(seq_metadata_list)
        with span(self._metrics_store, LAUNCH) as s:
            graphs = len(self.graphs)
            samples = self._launch(inputs, n_pre, mode)
            if s.recording:
                s.counts["captured"] = len(self.graphs) - graphs
        if inputs.pod:
            self.backend.pod_steps += 1
        event = None
        if samples.is_cuda:
            host = torch.empty(samples.shape, dtype=samples.dtype,
                               pin_memory=True)
            host.copy_(samples, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
            samples = host

        ce = self.cache_engine
        sampled = []
        for meta in seq_metadata_list:
            seq = meta.seq
            if meta.is_prompt:
                processed = seq.get_num_prompt_tokens_processed()
                if processed + meta.prompt_chunk_len < seq.get_prompt_len():
                    continue  # mid-prompt chunk: nothing sampled
            sampled.append((seq, ce.slot_of(meta.seq_id), seq.generation))
        return StepHandle(seq_metadata_list, sampled, samples,
                          self.logprobs_top, event)

    @staticmethod
    def resolve(handle: StepHandle) -> SamplerOutputs:
        """The dispatched step's samples (waits for their copy to land)."""
        handle.wait()
        tokens, lps, top_ids, top_lps = unpack_samples(
            handle.samples.numpy(), handle.n_top)
        return [SamplerOutput(
                    seq.seq_id, int(tokens[slot]),
                    logprob=float(lps[slot]),
                    top_logprobs=(
                        None if top_ids is None else
                        [(int(i), float(p)) for i, p in
                         zip(top_ids[slot], top_lps[slot])]))
                for seq, slot, gen in handle.sampled
                if seq.generation == gen]

    def run(self, seq_metadata_list: List[SequenceMetadata]
            ) -> SamplerOutputs:
        """One synchronous serving step: returns this step's samples."""
        if not seq_metadata_list:
            return []
        return self.resolve(self.run_async(seq_metadata_list))

    def cleanup(self) -> None:
        """Drop the device state: weights, graphs and their pool, the token
        buffer and the staging buffers."""
        self.params = None
        self.graphs.clear()
        self._pool = None
        self._tok_buf = None
        self._stager.cleanup()
