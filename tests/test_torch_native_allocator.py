"""The port's binding of the native allocator core, on the CPU.

``vattention_tpu_torch/memory/native.py`` compiles ``csrc/vattn_allocator.cc``
with g++ at first use into ``build/vattention_tpu_torch/`` (never into the
JAX package's directory).  The differential fuzz of
``tests/test_allocator.py::test_native_allocator_parity`` runs here against
the port's Python allocator: the same slots, free-block counts and extent
tables at every step, the relocation plans safe under sequential
execution, and a second instance untouched.  (The JAX side of that fuzz
skips on a host where the JAX package's library is not built; this one
builds its own.)  The port's engine takes the native core by default and
for ``use_native_allocator=True``, the Python one for ``False``, with the
same greedy tokens and extent tables; a core that does not build raises.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from vattention_tpu_torch import LLMEngine, SamplingParams
from vattention_tpu_torch.memory import native
from vattention_tpu_torch.memory.allocator import VAttentionAllocator
from vattention_tpu_torch.memory.native import NativeVAttentionAllocator

from test_torch_engine import fresh_metrics

KB = 1024
MB = 1024 * KB
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _fresh_metrics():
    fresh_metrics()
    yield
    fresh_metrics()


def make(cls, max_bs=8, max_ctx=4096, layers=4, kv_heads=2, mem_mb=8,
         megacache=False, max_segments=8):
    a = cls()
    a.init_kvcache(num_layers=layers, num_kv_heads=kv_heads, head_size=128,
                   max_batch_size=max_bs, max_context_length=max_ctx,
                   dtype_bytes=2, page_size=64 * KB, megacache=megacache,
                   max_segments=max_segments)
    a.reserve_physical_pages(mem_mb * MB)
    return a


class ArenaMirror:
    """The arena's blocks on the host, through the allocator's API: each
    block under a request's live tokens holds a payload stamped when it
    became live, a plan's moves run in order as kernel D runs them, and
    every live block must keep its payload.  (``tests/test_allocator.py``'s
    mirrors stamp every mapped block, eager and over-committed ones too,
    which a long fuzz then finds "corrupted" once the allocator reuses
    them: they hold no tokens.)"""

    def __init__(self, a):
        self.a = a
        self.data = np.full(a.num_arena_blocks, -1, dtype=np.int64)
        self.contents = {}  # slot -> payloads of its live blocks, in order

    def live_blocks(self, sid):
        seg_row, seg_tok = self.a.get_batch_segments()
        bt = self.a.block_tokens
        blocks = [b for row, tok in zip(seg_row[sid], seg_tok[sid])
                  for b in range(row // bt, (row + tok) // bt)]
        return blocks[:self.a.tokens_to_blocks(self.a.seq_lens[sid])]

    def write_new_blocks(self, sid):
        blocks = self.live_blocks(sid)
        cur = self.contents.setdefault(sid, [])
        del cur[len(blocks):]
        while len(cur) < len(blocks):
            payload = hash((sid, len(cur))) % (1 << 31)
            self.data[blocks[len(cur)]] = payload
            cur.append(payload)

    def apply(self, plan):
        for m in plan.moves:
            self.data[m.dst] = self.data[m.src]

    def check(self):
        for sid, payloads in self.contents.items():
            for i, b in enumerate(self.live_blocks(sid)[:len(payloads)]):
                assert self.data[b] == payloads[i], (
                    f"slot {sid} block {i} corrupted after relocation")


def test_the_core_builds_into_the_ports_build_directory():
    path = native.build()
    assert path.parent == ROOT / "build" / "vattention_tpu_torch"
    assert path.name.startswith("libvattn_allocator-") and path.exists()
    assert path == native.library_path()
    assert not list(path.parent.glob("libvattn_allocator-*.tmp"))
    a = make(NativeVAttentionAllocator)
    assert a.block_tokens == make(VAttentionAllocator).block_tokens


def test_processes_that_build_at_once_all_load_the_core(tmp_path):
    """Four processes build into one empty directory together: each
    writes its own temporary file and renames it into place, so every one
    loads a whole library and no temporary file is left."""
    script = (
        "import sys\n"
        "from pathlib import Path\n"
        "from vattention_tpu_torch.memory import native\n"
        f"native.BUILD_DIR = Path({str(tmp_path)!r})\n"
        "a = native.NativeVAttentionAllocator()\n"
        "a.init_kvcache(2, 2, 128, 4, 1024, 2, 65536)\n"
        "a.reserve_physical_pages(1 << 22)\n"
        "print(a.alloc_new_batch_idx(100), a.block_tokens)\n")
    procs = [subprocess.Popen([sys.executable, "-c", script], cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(4)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.split()[0] == "0"
    libs = sorted(q.name for q in tmp_path.iterdir())
    assert libs == [native.library_path().name]


@pytest.mark.parametrize("max_segments,megacache",
                         [(8, False), (8, True), (2, False), (1, False)])
def test_native_allocator_parity(max_segments, megacache):
    """The differential fuzz: 1000 steps of random admissions, growth and
    frees through both allocators, which must agree on every slot and
    every free-block count; the native plans applied to a mirrored arena
    keep every request's data in place.  At the 8 extents per request the
    cache engine asks for, the extent tables agree at every step too.  With
    1 or 2 extents the allocator relocates often, and there the two cores
    may pick other destinations for a move (the same .cc and allocator.py
    as the JAX package's), so only the accounting and the data are held."""
    kw = dict(max_segments=max_segments, megacache=megacache)
    nat = make(NativeVAttentionAllocator, **kw)
    ref = make(VAttentionAllocator, **kw)
    assert nat.block_tokens == ref.block_tokens
    assert nat.num_arena_blocks == ref.num_arena_blocks

    # a second instance (another geometry) beside the first
    other = make(NativeVAttentionAllocator, max_bs=4, max_ctx=2048,
                 layers=2, kv_heads=4, mem_mb=4)
    other_sid = other.alloc_new_batch_idx(100)
    other.step_async(other.seq_lens)
    other_segs = other.get_batch_segments()

    rng = np.random.default_rng(7)
    mirror = ArenaMirror(nat)
    active = {}
    moves = 0
    for _ in range(1000):
        if len(active) < 7 and rng.random() < 0.5:
            prompt = int(rng.integers(10, 1500))
            if nat.tokens_to_blocks(prompt) < nat.num_free_kvblocks():
                sid = nat.alloc_new_batch_idx(prompt)
                assert sid == ref.alloc_new_batch_idx(prompt)
                if sid >= 0:
                    active[sid] = int(rng.integers(4, 80))
                    mirror.contents.pop(sid, None)
        while nat.num_free_kvblocks() < len(active) and len(active) > 1:
            victim = list(active)[-1]
            nat.free_batch_idx(victim)
            ref.free_batch_idx(victim)
            del active[victim]
            mirror.contents.pop(victim, None)
        seq_lens = nat.seq_lens
        np.testing.assert_array_equal(seq_lens, ref.seq_lens)
        for sid in list(active):
            seq_lens[sid] += 1
            active[sid] -= 1
        plan = nat.step_async(seq_lens.copy())
        ref.step_async(seq_lens.copy())
        moves += len(plan.moves)
        assert nat.num_free_kvblocks() == ref.num_free_kvblocks()
        seg_tok = nat.get_batch_segments()[1]
        assert ((seg_tok > 0).sum(axis=1) <= max_segments).all()
        if max_segments == 8:
            for x, y in zip(nat.get_batch_segments(),
                            ref.get_batch_segments()):
                np.testing.assert_array_equal(x, y)
            assert nat.fragmentation_overhead() == pytest.approx(
                ref.fragmentation_overhead(), abs=1e-12)
        mirror.apply(plan)
        for sid in active:
            mirror.write_new_blocks(sid)
        mirror.check()
        for sid in [s for s, d in active.items() if d <= 0]:
            nat.free_batch_idx(sid)
            ref.free_batch_idx(sid)
            del active[sid]
            mirror.contents.pop(sid, None)
    if max_segments < 8 or megacache:
        assert moves > 0  # the fuzz reaches the relocation path
    for x, y in zip(other.get_batch_segments(), other_segs):
        np.testing.assert_array_equal(x, y)
    assert other.seq_lens[other_sid] == 100


def serve_recording_extents(engine, prompts, max_tokens):
    """Greedy tokens of ``prompts`` and the extent tables after each step."""
    for seq_id, ids in prompts.items():
        engine.add_request(prompt=None, prompt_token_ids=ids,
                           sampling_params=SamplingParams(
                               temperature=0.0, max_tokens=max_tokens,
                               ignore_eos=True),
                           seq_id=seq_id)
    ce = engine.worker.cache_engine
    out, tables = {}, []
    while engine.has_unfinished_requests():
        for o in engine.step():
            if o.finished:
                out[o.seq_id] = o.token_ids
        tables.append([t.copy() for t in ce.get_batch_segments()])
        assert len(tables) < 500
    return out, tables


def test_engine_tokens_and_extents_equal_with_the_native_core_on_and_off():
    """None (the default) and True take the native core, False the Python
    allocator; on 64 KB pages (64-token blocks) three requests growing side
    by side take a second extent; the tokens and the extent tables after
    every step are the same."""
    rng = np.random.default_rng(5)
    prompts = {f"r{i}": rng.integers(1, 2000, 60).tolist() for i in range(3)}
    runs = {}
    for flag, cls in ((None, NativeVAttentionAllocator),
                      (True, NativeVAttentionAllocator),
                      (False, VAttentionAllocator)):
        fresh_metrics()
        engine = LLMEngine.from_engine_args(
            model="tiny-llama-debug", dtype="float32",
            attention_backend="fa_vattn_64kb", scheduler_type="sarathi",
            max_model_len=512, max_batch_size=4, max_num_seqs=4,
            chunk_size=128, device="cpu", use_native_allocator=flag)
        assert type(engine.worker.cache_engine.allocator) is cls
        runs[flag] = serve_recording_extents(engine, prompts, 80)
        engine.cleanup()
    (tok_n, ext_n), (tok_t, ext_t), (tok_p, ext_p) = runs.values()
    assert tok_n == tok_t == tok_p
    assert len(ext_n) == len(ext_p) and len(ext_t) == len(ext_p)
    assert any((seg_tok > 0).sum(axis=1).max() > 1 for _, seg_tok in ext_p)
    for a, b, c in zip(ext_n, ext_t, ext_p):
        for x, y, z in zip(a, b, c):
            np.testing.assert_array_equal(x, z)
            np.testing.assert_array_equal(y, z)


def test_a_core_that_does_not_build_raises(tmp_path, monkeypatch):
    """No fallback to the Python allocator: the engine raises with the
    compiler's message."""
    bad = tmp_path / "vattn_allocator.cc"
    bad.write_text("int vattn_create( { this is not C++ }\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match=r"g\+\+ failed for vattn_allocator.cc"):
        native.build()
    with pytest.raises(RuntimeError, match="error"):
        LLMEngine.from_engine_args(
            model="tiny-llama-debug", dtype="float32",
            attention_backend="fa_vattn", max_model_len=256,
            max_batch_size=2, max_num_seqs=2, device="cpu")
    assert not list((tmp_path / "build").glob("*.tmp"))
