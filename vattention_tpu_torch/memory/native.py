"""ctypes binding of the native C++ allocator core (``csrc/vattn_allocator.cc``).

Counterpart of ``vattention_tpu/memory/native.py``: the same C ABI, the same
``ctypes`` signatures and the same Python API as ``memory/allocator.py``'s
``VAttentionAllocator``, which it replaces in the cache engine.  The core
keeps per-step host bookkeeping off the serving path at large arena sizes.

The port builds the core itself, at first use: ``g++ -O2 -fPIC -std=c++17
-shared`` into ``build/vattention_tpu_torch/`` at the repository root (the
directory the CUDA kernels are built into), named by a hash of the source
and the flags.  Each build writes a name unique to its process and thread
and renames it into place, so processes that build at once never load a
half-written library.  A failed build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

from vattention_tpu_torch.memory.allocator import Relocation, RelocationPlan

SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "vattn_allocator.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "vattention_tpu_torch"
CXX_FLAGS = ["-O2", "-fPIC", "-std=c++17", "-shared"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libvattn_allocator-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the core unless its library exists; returns its path."""
    target = library_path()
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for {SOURCE.name}:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, target)
    return target


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        i64, i32p, i64p = (ctypes.c_int64, ctypes.POINTER(ctypes.c_int32),
                          ctypes.POINTER(ctypes.c_int64))
        lib.vattn_create.argtypes = []
        lib.vattn_create.restype = i64
        for void in ("vattn_destroy", "vattn_init_kvcache",
                     "vattn_free_batch_idx", "vattn_set_deferred_reclamation",
                     "vattn_get_batch_segments", "vattn_get_seq_lens",
                     "vattn_cleanup"):
            getattr(lib, void).restype = None
        lib.vattn_destroy.argtypes = [i64]
        lib.vattn_init_kvcache.argtypes = [i64] * 8 + [ctypes.c_int, i64]
        lib.vattn_reserve_physical_pages.restype = i64
        lib.vattn_reserve_physical_pages.argtypes = [i64, i64]
        lib.vattn_block_tokens.restype = i64
        lib.vattn_block_tokens.argtypes = [i64]
        lib.vattn_num_arena_blocks.restype = i64
        lib.vattn_num_arena_blocks.argtypes = [i64]
        lib.vattn_num_free_kvblocks.restype = i64
        lib.vattn_num_free_kvblocks.argtypes = [i64]
        lib.vattn_step_async.restype = i64
        lib.vattn_step_async.argtypes = [i64, i64p, i32p, i32p, i64]
        lib.vattn_step_sync.restype = i64
        lib.vattn_step_sync.argtypes = [i64, i64p, ctypes.c_int, i32p, i32p,
                                        i64]
        lib.vattn_alloc_new_batch_idx.restype = i64
        lib.vattn_alloc_new_batch_idx.argtypes = [i64, i64]
        lib.vattn_free_batch_idx.argtypes = [i64, i64]
        lib.vattn_set_deferred_reclamation.argtypes = [i64, ctypes.c_int]
        lib.vattn_get_batch_segments.argtypes = [i64, i32p, i32p]
        lib.vattn_get_seq_lens.argtypes = [i64, i64p]
        lib.vattn_cleanup.argtypes = [i64]
        _lib = lib
        return lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


class NativeVAttentionAllocator:
    """Drop-in for ``VAttentionAllocator`` backed by the C++ core.

    Handle-based: each instance owns a C++ instance (``vattn_create``), so
    several engines coexist in one process.
    """

    def __init__(self):
        self.lib = _load()
        self._h = int(self.lib.vattn_create())
        self.is_configured = False

    def __del__(self):
        try:
            self.lib.vattn_destroy(self._h)
        except Exception:  # noqa: BLE001 -- interpreter teardown
            pass

    def init_kvcache(self, num_layers, num_kv_heads, head_size,
                     max_batch_size, max_context_length, dtype_bytes,
                     page_size, megacache=False, max_segments=8):
        self.lib.vattn_init_kvcache(
            self._h, num_layers, num_kv_heads, head_size, max_batch_size,
            max_context_length, dtype_bytes, page_size,
            1 if megacache else 0, max_segments)
        self.max_batch_size = max_batch_size
        self.max_segments = max_segments
        self.num_layers = num_layers
        self.megacache = megacache
        self.page_size = page_size
        self.pages_per_kvblock = 2 if megacache else 2 * num_layers
        self.kvblock_bytes = self.pages_per_kvblock * page_size
        self.is_configured = True
        self._moves_cap = 1 << 16
        self._src = np.zeros(self._moves_cap, np.int32)
        self._dst = np.zeros(self._moves_cap, np.int32)

    def reserve_physical_pages(self, free_memory: int) -> int:
        pages = int(self.lib.vattn_reserve_physical_pages(
            self._h, free_memory))
        self.block_tokens = int(self.lib.vattn_block_tokens(self._h))
        self.num_arena_blocks = int(
            self.lib.vattn_num_arena_blocks(self._h))
        return pages

    @property
    def arena_tokens(self) -> int:
        return self.num_arena_blocks * self.block_tokens

    @property
    def seq_lens(self) -> np.ndarray:
        out = np.zeros(self.max_batch_size, np.int64)
        self.lib.vattn_get_seq_lens(self._h, _ptr(out, ctypes.c_int64))
        return out

    def tokens_to_blocks(self, n: int) -> int:
        return -(-int(n) // self.block_tokens)

    def blocks_to_tokens(self, n: int) -> int:
        return int(n) * self.block_tokens

    def num_free_kvblocks(self) -> int:
        return int(self.lib.vattn_num_free_kvblocks(self._h))

    def _plan(self, n: int) -> RelocationPlan:
        if n > self._moves_cap:
            raise RuntimeError(f"relocation plan of {n} moves overflows "
                               f"its buffer of {self._moves_cap}")
        plan = RelocationPlan()
        plan.moves.extend(Relocation(int(s), int(d))
                          for s, d in zip(self._src[:n], self._dst[:n]))
        return plan

    def _seq_lens_arg(self, seq_lens: Sequence[int]) -> np.ndarray:
        """The core reads one length per batch slot."""
        arr = np.ascontiguousarray(seq_lens, np.int64)
        if arr.shape != (self.max_batch_size,):
            raise ValueError(f"seq_lens of shape {arr.shape}, expected "
                             f"({self.max_batch_size},)")
        return arr

    def step_async(self, seq_lens: Sequence[int]) -> RelocationPlan:
        arr = self._seq_lens_arg(seq_lens)
        return self._plan(int(self.lib.vattn_step_async(
            self._h, _ptr(arr, ctypes.c_int64),
            _ptr(self._src, ctypes.c_int32), _ptr(self._dst, ctypes.c_int32),
            self._moves_cap)))

    def step_sync(self, seq_lens: Sequence[int],
                  eager_reclaim: bool = False) -> RelocationPlan:
        arr = self._seq_lens_arg(seq_lens)
        return self._plan(int(self.lib.vattn_step_sync(
            self._h, _ptr(arr, ctypes.c_int64), 1 if eager_reclaim else 0,
            _ptr(self._src, ctypes.c_int32), _ptr(self._dst, ctypes.c_int32),
            self._moves_cap)))

    def alloc_new_batch_idx(self, seqlen: int) -> int:
        return int(self.lib.vattn_alloc_new_batch_idx(self._h, int(seqlen)))

    def free_batch_idx(self, slot: int) -> None:
        self.lib.vattn_free_batch_idx(self._h, int(slot))

    def set_deferred_reclamation(self, val: bool) -> None:
        self.lib.vattn_set_deferred_reclamation(self._h, 1 if val else 0)

    def get_batch_segments(self) -> Tuple[np.ndarray, np.ndarray]:
        B, S = self.max_batch_size, self.max_segments
        seg_row = np.zeros((B, S), np.int32)
        seg_tok = np.zeros((B, S), np.int32)
        self.lib.vattn_get_batch_segments(
            self._h, _ptr(seg_row, ctypes.c_int32),
            _ptr(seg_tok, ctypes.c_int32))
        return seg_row, seg_tok

    def fragmentation_overhead(self) -> float:
        """Fraction of arena blocks lost to over-commitment and headroom
        (as ``VAttentionAllocator.fragmentation_overhead``)."""
        if getattr(self, "num_arena_blocks", 0) == 0:
            return 0.0
        seq_lens = self.seq_lens
        seg_row, seg_tok = self.get_batch_segments()
        live = seq_lens > 0
        required = sum(self.tokens_to_blocks(int(s)) for s in seq_lens[live])
        used = int((seg_tok[live].sum(axis=1) // self.block_tokens).sum())
        return (used - required) / self.num_arena_blocks

    def cleanup(self) -> None:
        self.lib.vattn_cleanup(self._h)
        self.is_configured = False
