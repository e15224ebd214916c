"""Build, load and launch the port's hand-written CUDA kernels.

Each kernel source under ``vattention_tpu_torch/csrc/`` is compiled by
``nvcc`` for ``sm_90a`` into a shared library with a plain C interface and
loaded with ``ctypes`` (no PyTorch headers, so a build takes seconds).
Libraries go to ``build/vattention_tpu_torch/`` at the repository root,
named by a hash of their source, every header it includes from ``csrc/``
(followed transitively) and the flags, and are built at first use:
the first launch of any kernel compiles every source that is not built
yet, one ``nvcc`` process per source, all started together.  Nothing is
built or imported when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Sequence

import torch

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "vattention_tpu_torch"
SOURCES = ("kv_append", "prefill_attention", "decode_attention",
           "arena_relocate", "paged_prefill_attention", "pod_attention",
           "norm_act")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# dtype codes of csrc/common.cuh: the compute dtype (q, outputs, the
# model's K/V) and the arena's storage dtype
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
KV_DTYPE_CODES = {**DTYPE_CODES, torch.float8_e4m3fn: 2, torch.int8: 3}
# the arena dtypes each compute dtype's kernels are built for
KV_DTYPES = {torch.float32: (torch.float32, torch.float8_e4m3fn, torch.int8),
             torch.bfloat16: (torch.bfloat16, torch.float8_e4m3fn,
                              torch.int8)}

_lock = threading.Lock()
_libraries: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


_LOCAL_INCLUDE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def source_files(name: str) -> List[Path]:
    """``<name>.cu`` and every header it includes with ``#include "..."``,
    transitively, in the order first met."""
    files: List[Path] = []
    todo = [CSRC_DIR / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in files:
            continue
        files.append(path)
        todo.extend(path.parent / inc
                    for inc in _LOCAL_INCLUDE.findall(path.read_text()))
    return files


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in source_files(name):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Sequence[str] = SOURCES) -> Dict[str, float]:
    """Compile every listed source whose library is missing, in parallel.

    Returns the wall seconds of each compile started (empty when all were
    built already).  The ptxas report of each build is kept next to its
    library as ``<library>.log``.  Raises with the compiler output on
    failure.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = {}
    for name in names:
        target = library_path(name)
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        started[name] = (proc, tmp, target, time.perf_counter())
    seconds = {}
    failures: List[str] = []
    for name, (proc, tmp, target, t0) in started.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        target.with_suffix(".so.log").write_text(log)
        os.replace(tmp, target)
    if failures:
        raise RuntimeError("\n".join(failures))
    return seconds


def library(name: str) -> ctypes.CDLL:
    with _lock:
        if name not in _libraries:
            build_all()
            _libraries[name] = ctypes.CDLL(str(library_path(name)))
        return _libraries[name]


def current_stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


class CudaKernel:
    """One kernel's C entry point and its count of launches.

    ``launches`` grows by one for each launch the kernel accepted, and for
    nothing else; callers that want to count a window of work set it to 0
    first.  A call under CUDA graph capture counts too; the model runner,
    which captures the serving step, takes a graph's calls back off after
    the capture and adds them again at each replay (``INSTANCES`` lists
    every kernel for that).
    """

    INSTANCES: List["CudaKernel"] = []

    def __init__(self, source: str, symbol: str, argtypes: Sequence):
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None
        CudaKernel.INSTANCES.append(self)

    def __call__(self, *args) -> None:
        if self._fn is None:
            lib = library(self.source)
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            lib.vattn_error_string.argtypes = [ctypes.c_int]
            lib.vattn_error_string.restype = ctypes.c_char_p
            self._error_string = lib.vattn_error_string
            self._fn = fn
        err = self._fn(*args)
        if err != 0:
            raise RuntimeError(
                f"{self.symbol}: launch failed with CUDA error {err} "
                f"({self._error_string(err).decode()})")
        self.launches += 1


def check_kv_cache(kv_cache: torch.Tensor, dtype: torch.dtype,
                   device) -> None:
    """Raise unless ``kv_cache`` is an arena the kernels of compute dtype
    ``dtype`` read: its own dtype, or 1-byte e4m3 or int8."""
    check_cuda_tensor("kv_cache", kv_cache, None, device)
    if kv_cache.dtype not in KV_DTYPES.get(dtype, ()):
        raise ValueError(
            f"kv_cache has dtype {kv_cache.dtype}; {dtype} kernels read "
            f"{KV_DTYPES.get(dtype, ())}")


def check_cuda_tensor(name: str, t: torch.Tensor, dtype=None,
                      device=None) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` on
    ``device`` with a 16-byte aligned base (the kernels' vector loads)."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} is not 16-byte aligned")
