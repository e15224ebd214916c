"""The port's control plane against the JAX package's, on the same traces.

The port keeps its own copies of the schedulers, block-space managers,
sequence types and the Python allocator; these tests hold the copies to
the originals: the same request trace gives identical SchedulerOutputs
under each of the five schedulers and both block-space managers (arena
and block table), and the same allocator workload gives
identical segment tables and relocation plans at every step.  One
deliberate divergence is pinned: the port's arena block-space manager
keeps the unmapped blocks of admitted prompts promised.
"""

import importlib

import numpy as np
import pytest

PACKAGES = ("vattention_tpu", "vattention_tpu_torch")
MB = 1024 * 1024


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def scheduler_trace(pkg, sched_type, blocks, backend="fa_vattn"):
    """Drive one package's scheduler over a fixed request trace, applying
    the engine's post-step transitions; returns every step's outputs as
    plain tuples."""
    config = _mod(pkg, "config")
    seq_mod = _mod(pkg, "core.datatypes.sequence")
    status = _mod(pkg, "core.datatypes.sequence_status").SequenceStatus
    sp = _mod(pkg, "core.datatypes.sampling_params").SamplingParams
    registry = _mod(pkg, "core.scheduler.scheduler_registry")
    cfg_cls = {
        "sarathi": config.SarathiSchedulerConfig,
        "vllm": config.VllmSchedulerConfig,
        "simple_chunking": config.SimpleChunkingSchedulerConfig,
        "orca": config.OrcaSchedulerConfig,
        "faster_transformer": config.FasterTransformerSchedulerConfig,
    }[sched_type]
    kw = dict(max_num_seqs=4, max_model_len=2048)
    if sched_type in ("sarathi", "simple_chunking"):
        kw["chunk_size"] = 256
    sched = registry.SchedulerRegistry.get(
        config.SchedulerType(sched_type), cfg_cls(**kw),
        config.CacheConfig(block_size=64, num_gpu_blocks=blocks))
    sched.set_block_manager(config.ModelConfig(
        model="tiny-llama-debug", attention_backend=backend))
    if hasattr(sched.block_manager, "set_free_blocks"):
        sched.block_manager.set_free_blocks(blocks)
    rng = np.random.default_rng(3)
    seqs = {}
    for i in range(7):
        n = int(rng.integers(20, 700))
        seqs[f"q{i}"] = seq_mod.Sequence(
            f"q{i}", None, list(range(1, n + 1)), 64, -1, 0.0,
            sp(temperature=0.0, max_tokens=int(rng.integers(2, 40)),
               ignore_eos=True))
        sched.add_seq(seqs[f"q{i}"])
    log = []
    for _ in range(400):
        if not sched.has_unfinished_seqs():
            break
        out = sched.schedule()
        for seq_id in out.preempted_seq_ids:
            seqs[seq_id].reset_for_recompute()
        log.append((
            [(m.seq_id, m.is_prompt, m.prompt_chunk_len)
             for m in out.scheduled_seq_metadata_list],
            list(out.preempted_seq_ids), list(out.ignored_seq_ids),
            out.num_batched_tokens))
        for meta in out.scheduled_seq_metadata_list:
            seq = next(s for s in sched.running if s.seq_id == meta.seq_id)
            seq.set_status(status.RUNNING)
            if meta.is_prompt:
                seq.update_prompt_tokens_processed(meta.prompt_chunk_len)
            seq.set_status(status.PAUSED)
            if seq.prompt_processing_finished and not meta.is_prompt:
                seq.append_token_id(1)
                seq.check_stop()
        sched.on_step_completed()
    return log


@pytest.mark.parametrize("sched_type", ["sarathi", "vllm", "simple_chunking",
                                        "orca", "faster_transformer"])
@pytest.mark.parametrize("blocks", [12, 64])
@pytest.mark.parametrize("backend", ["fa_vattn", "fa_paged_16"])
def test_scheduler_outputs_identical(sched_type, blocks, backend):
    """blocks=12 runs under memory pressure (preemption); 64 does not.
    fa_vattn accounts with the arena's block-space manager, fa_paged_16
    with the scheduler's own block-table manager."""
    jax_log, torch_log = (scheduler_trace(p, sched_type, blocks, backend)
                          for p in PACKAGES)
    assert len(jax_log) > 3
    assert torch_log == jax_log


def allocator_trace(pkg, max_segments, steps=500):
    alloc_cls = _mod(pkg, "memory.allocator").VAttentionAllocator
    a = alloc_cls()
    a.init_kvcache(num_layers=4, num_kv_heads=2, head_size=128,
                   max_batch_size=8, max_context_length=4096, dtype_bytes=2,
                   page_size=64 * 1024, max_segments=max_segments)
    a.reserve_physical_pages(8 * MB)
    rng = np.random.default_rng(7)
    active, log = {}, []
    for _ in range(steps):
        if len(active) < 7 and rng.random() < 0.5:
            prompt = int(rng.integers(10, 1500))
            if a.tokens_to_blocks(prompt) < a.num_free_kvblocks():
                sid = a.alloc_new_batch_idx(prompt)
                if sid >= 0:
                    active[sid] = int(rng.integers(4, 80))
        while a.num_free_kvblocks() < len(active) and len(active) > 1:
            victim = list(active)[-1]
            a.free_batch_idx(victim)
            del active[victim]
        for sid in list(active):
            a.seq_lens[sid] += 1
            active[sid] -= 1
        plan = a.step_async(a.seq_lens.copy())
        seg_row, seg_tok = a.get_batch_segments()
        log.append(([(m.src, m.dst) for m in plan.moves],
                    seg_row.tolist(), seg_tok.tolist(),
                    int(a.num_free_kvblocks())))
        for sid in [s for s, d in active.items() if d <= 0]:
            a.free_batch_idx(sid)
            del active[sid]
    return log


@pytest.mark.parametrize("max_segments", [1, 2, 8])
def test_allocator_segment_tables_identical(max_segments):
    jax_log, torch_log = (allocator_trace(p, max_segments)
                          for p in PACKAGES)
    if max_segments == 1:
        assert any(moves for moves, *_ in jax_log), "no relocation exercised"
    assert torch_log == jax_log


def test_admitted_prompts_keep_their_blocks_promised():
    """A deliberate divergence: the allocator maps a prompt chunk by chunk,
    so after the step that admits a request its free count no longer
    holds the blocks the rest of the prompt needs.  The port's arena
    block-space manager starts each schedule's promises from those
    blocks; the JAX package's starts from 0 and admits a second request
    into blocks the first still needs (both prompts together past the
    arena)."""
    promised, admits = {}, {}
    for pkg in PACKAGES:
        bm_mod = _mod(pkg, "core.block_space_manager."
                      "vattention_block_space_manager")
        seq_mod = _mod(pkg, "core.datatypes.sequence")
        sp = _mod(pkg, "core.datatypes.sampling_params").SamplingParams

        def seq(seq_id, blocks):
            return seq_mod.Sequence(
                seq_id, None, list(range(1, 128 * blocks + 1)), 128, -1, 0.0,
                sp(temperature=0.0, max_tokens=4, ignore_eos=True))
        bm = bm_mod.vAttentionBlockSpaceManager(128, 100, 8192)
        bm.set_free_blocks(100)
        a, b = seq("a", 40), seq("b", 60)
        bm.clear_promised_blocks()
        assert bm.can_allocate(a)
        bm.allocate(a)
        # the step maps a's first chunk of 512 tokens (4 blocks)
        a.update_prompt_tokens_processed(512)
        bm.set_free_blocks(96)
        bm.clear_promised_blocks()
        promised[pkg] = bm.promised_blocks
        admits[pkg] = bm.can_allocate(b)
    assert promised == {"vattention_tpu": 0, "vattention_tpu_torch": 36}
    assert admits == {"vattention_tpu": True, "vattention_tpu_torch": False}
