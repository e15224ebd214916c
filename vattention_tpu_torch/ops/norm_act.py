"""The layer's elementwise work as four kernels: residual add + RMSNorm,
SiLU-and-mul, Falcon's residual adds + LayerNorm, and ``gelu_new``.

The JAX step runs this work as plain jnp that XLA fuses into the jitted
step (``vattention_tpu/model_executor/layers/layernorm.py``,
``activation.py``, the residual adds of ``models/llama.py`` and
``models/falcon.py``), so no TPU kernel is replaced: eagerly, each of
these functions was a chain of PyTorch kernels (a cast, a square, a mean,
an rsqrt, two products and a cast for one norm).  Each wrapper takes its
plain version (beside it here, built from ``layers/layernorm.py`` and
``layers/activation.py``) for a CPU tensor and launches its kernel for a
CUDA tensor, raising on anything the kernel does not take.

The models carry the residual as the reference's serving stack does: a
layer's o-projection output is added inside ``post_norm``'s call, its
MLP output inside the next layer's ``input_norm`` call, and the last
layer's inside the final norm's (``add_rms_norm``); falcon adds ``x + (o
+ mlp)`` inside the next LayerNorm (``add_layer_norm``).  Rounding is the
JAX step's, one rounding to the model's dtype per JAX op: the residual
output equals the plain ``x + r`` bit for bit.

Bound on the H100: bytes (each input read once, each output written
once).  Source: csrc/norm_act.cu.  ``add_rms_norm``, ``silu_and_mul`` and
``gelu_new`` take their launch plan from here (``norm_plan``,
``silu_plan``, ``gelu_plan``): a row group of whole warps per row, several
narrow rows a block, every load of a row (the weight's too) in flight at
once; a 2-D grid of (row, column tile) blocks whose threads each load
their one or two gate/up pairs before computing; and one vector a thread
over the flat tensor.  ``add_layer_norm`` is one block per row.
``gelu_new`` computes x / (1 + exp(-2u)) with the card's fast
exponential and division (the error argument is in the source).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from vattention_tpu_torch.model_executor.layers.activation import (
    gelu_new as gelu_new_plain, silu_and_mul as silu_and_mul_plain)
from vattention_tpu_torch.model_executor.layers.layernorm import (layer_norm,
                                                                  rms_norm)
from vattention_tpu_torch.ops.cuda_build import (DTYPE_CODES, CudaKernel,
                                                 check_cuda_tensor,
                                                 current_stream)

__all__ = ["add_rms_norm", "add_rms_norm_plain", "add_layer_norm",
           "add_layer_norm_plain", "silu_and_mul", "silu_and_mul_plain",
           "gelu_new", "gelu_new_plain", "norm_plan", "silu_plan",
           "gelu_plan"]

_P, _I = ctypes.c_void_p, ctypes.c_int
ADD_RMS_NORM = CudaKernel("norm_act", "vattn_add_rms_norm", [
    _P, _P, _P, _P, _P, _I, _I, ctypes.c_float, _I, _I, _I, _I, _P])
ADD_LAYER_NORM = CudaKernel("norm_act", "vattn_add_layer_norm", [
    _P, _P, _P, _P, _P, _P, _P, _I, _I, ctypes.c_float, _I, _P])
SILU_AND_MUL = CudaKernel("norm_act", "vattn_silu_and_mul", [
    _P, _P, _I, _I, _I, _I, _I, _I, _P])
GELU_NEW = CudaKernel("norm_act", "vattn_gelu_new", [
    _P, _P, ctypes.c_longlong, _I, _I, _I, _I, _P])

Pair = Tuple[torch.Tensor, torch.Tensor]
# the source's limits (csrc/norm_act.cu): add_rms_norm's 16-byte vectors
# a thread and threads a block at most (kMaxVecs, kNormThreads);
# silu_and_mul's gate/up pairs a thread, threads a block and column tiles
# (the grid's y) at most (kMaxActVecs, kActThreads, kMaxActTiles);
# gelu_new's threads a block (kActThreads too), vectors a thread (1, 2 or
# kMaxGeluVecs for bench_norm_act --plans; gelu_plan takes 1) and vectors
# (kMaxGeluVectors: 32-bit indices) at most
MAX_VECS = 8
NORM_THREADS = 256
MAX_ACT_VECS = 2
ACT_THREADS = 256
MAX_ACT_TILES = 65535
MAX_GELU_VECS = 4
GELU_MAX_VECTORS = 2**31 - 1 - ACT_THREADS * MAX_GELU_VECS
# a normalized row's bytes at most: MAX_VECS 16-byte vectors for each of
# NORM_THREADS threads (bf16 rows to 16384 values, float32 to 8192)
MAX_ROW_BYTES = MAX_VECS * NORM_THREADS * 16
# silu_and_mul's plan: a block's threads, and the blocks a launch per SM
# below which a thread takes one gate/up pair instead of two
ACT_BLOCK = 128
ACT_BLOCKS_PER_SM = 2
# gelu_new's plan: a block's threads (one vector each)
GELU_BLOCK = 128


class NormPlan(NamedTuple):
    """add_rms_norm's launch: ``vpt`` 16-byte vectors a thread,
    ``row_threads`` threads (whole warps) a row, ``rows_per_block`` rows
    a block, ``blocks`` blocks."""
    vpt: int
    row_threads: int
    rows_per_block: int
    blocks: int


class SiluPlan(NamedTuple):
    """silu_and_mul's launch: blocks of ``threads``, ``vpt`` output
    vectors a thread, ``tiles`` blocks a row (the grid is rows x
    tiles)."""
    vpt: int
    threads: int
    tiles: int


class GeluPlan(NamedTuple):
    """gelu_new's launch over the flat tensor: ``vpt`` vectors a thread,
    blocks of ``threads``, ``blocks`` blocks."""
    vpt: int
    threads: int
    blocks: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _vectors(what: str, width: int, element_size: int) -> int:
    """16-byte vectors in ``width`` values; raises unless whole."""
    n_bytes = width * element_size
    if width <= 0 or n_bytes % 16:
        raise ValueError(f"{what}: {width} values of {element_size} bytes "
                         "are not a whole number of 16-byte vectors")
    return n_bytes // 16


@functools.lru_cache(maxsize=4096)
def norm_plan(rows: int, width: int, element_size: int,
              sms: int) -> NormPlan:
    """add_rms_norm's launch over [rows, width] values of
    ``element_size`` bytes on a card of ``sms`` SMs.  A thread takes the
    fewest of 1, 2, 4 or 8 vectors that fit the row in NORM_THREADS
    threads (so rows of at most MAX_ROW_BYTES); a block takes as many
    rows as fit NORM_THREADS threads while every SM still gets a block,
    else one.  (On the H100 fewer threads a row, with more vectors each,
    measured no faster at a 2048-row chunk and slower at decode rows.)"""
    nvec = _vectors("add_rms_norm", width, element_size)
    if rows < 0 or width * element_size > MAX_ROW_BYTES:
        raise ValueError(f"add_rms_norm: [{rows}, {width}] of "
                         f"{element_size}-byte values (rows at most "
                         f"{MAX_ROW_BYTES} bytes)")
    vpt = 1
    while vpt < MAX_VECS and _cdiv(nvec, vpt) > NORM_THREADS:
        vpt *= 2
    row_threads = _cdiv(_cdiv(nvec, vpt), 32) * 32
    per_block = max(1, min(NORM_THREADS // row_threads, rows // sms))
    return NormPlan(vpt, row_threads, per_block, _cdiv(rows, per_block))


@functools.lru_cache(maxsize=4096)
def silu_plan(rows: int, inter: int, element_size: int,
              sms: int) -> SiluPlan:
    """silu_and_mul's launch over [rows, 2 inter] values of
    ``element_size`` bytes on a card of ``sms`` SMs.  A thread takes
    MAX_ACT_VECS vectors (pairs of gate and up), or 1 when that would
    leave fewer than ACT_BLOCKS_PER_SM blocks an SM of ACT_BLOCK
    threads; a row's tiles are then cut even, each of the fewest whole
    warps that cover it.  (On the H100 4 and 8 pairs a thread measured
    slower in bfloat16.)"""
    per_row = _vectors("silu_and_mul", inter, element_size)
    if rows < 0:
        raise ValueError(f"silu_and_mul: {rows} rows")
    for vpt in (MAX_ACT_VECS, 1):
        tiles = _cdiv(per_row, ACT_BLOCK * vpt)
        if rows * tiles >= ACT_BLOCKS_PER_SM * sms:
            break
    threads = _cdiv(_cdiv(per_row, tiles * vpt), 32) * 32
    if tiles > MAX_ACT_TILES:
        raise ValueError(f"silu_and_mul: {inter} values a row need "
                         f"{tiles} tiles, above {MAX_ACT_TILES}")
    return SiluPlan(vpt, threads, tiles)


@functools.lru_cache(maxsize=4096)
def gelu_plan(numel: int, element_size: int) -> GeluPlan:
    """gelu_new's launch over ``numel`` values of ``element_size`` bytes,
    whatever their shape: one 16-byte vector a thread, blocks of
    GELU_BLOCK threads over the flat tensor in memory order.  (On the
    H100, (row, column tile) plans as silu_plan's, their blocks in a 2-D
    grid or in one dimension, measured 1-3% slower call by call and about
    6% slower inside falcon's captured steps; 2 or 4 vectors a thread and
    blocks of 64 or 256 threads within 1% call by call.)"""
    n_vec = _vectors("gelu_new", numel, element_size)
    if n_vec > GELU_MAX_VECTORS:
        raise ValueError(f"gelu_new: {numel} values, above "
                         f"{GELU_MAX_VECTORS} 16-byte vectors")
    return GeluPlan(1, GELU_BLOCK, _cdiv(n_vec, GELU_BLOCK))


_sms: Dict[torch.device, int] = {}


def _sm_count(device: torch.device) -> int:
    n = _sms.get(device)
    if n is None:
        n = _sms[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return n


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _check_rows(what: str, x: torch.Tensor, others, params) -> None:
    """Raise unless x is a contiguous [T, H] CUDA tensor of a kernel dtype
    with H a whole number of 16-byte vectors (MAX_ROW_BYTES at most),
    ``others`` (None or tensors) are its shape and dtype on its device,
    and ``params`` [H]."""
    check_cuda_tensor(what, x)
    row = x.shape[-1] * x.element_size()
    if (x.dtype not in DTYPE_CODES or x.dim() != 2 or row % 16
            or row > MAX_ROW_BYTES):
        raise ValueError(f"{what}: x {tuple(x.shape)} of {x.dtype}")
    for t in others:
        if t is not None:
            check_cuda_tensor(what, t, x.dtype, x.device)
            if t.shape != x.shape:
                raise ValueError(f"{what}: {tuple(t.shape)} against x "
                                 f"{tuple(x.shape)}")
    for t in params:
        check_cuda_tensor(what, t, x.dtype, x.device)
        if t.shape != (x.shape[1],):
            raise ValueError(f"{what}: weight {tuple(t.shape)} for x "
                             f"{tuple(x.shape)}")


def add_rms_norm_plain(x: torch.Tensor, r: Optional[torch.Tensor],
                       weight: torch.Tensor, eps: float) -> Pair:
    """Plain PyTorch version: ``s = x + r`` (x itself when r is None),
    then ``(s, rms_norm(s, weight, eps))``."""
    s = x if r is None else x + r
    return s, rms_norm(s, weight, eps)


def add_rms_norm(x: torch.Tensor, r: Optional[torch.Tensor],
                 weight: torch.Tensor, eps: float) -> Pair:
    """x, r: [T, H] of the model's dtype (float32 or bfloat16), r None for
    no addend; weight [H] of the same dtype.  Returns (x + r, rms_norm(x +
    r)), the residual rounded to the dtype before it is normalized (x
    itself when r is None)."""
    if not x.is_cuda:
        return add_rms_norm_plain(x, r, weight, eps)
    _check_rows("add_rms_norm", x, (r,), (weight,))
    out = torch.empty_like(x)
    res = x if r is None else torch.empty_like(x)
    if x.shape[0] == 0:
        return res, out
    plan = norm_plan(x.shape[0], x.shape[1], x.element_size(),
                     _sm_count(x.device))
    ADD_RMS_NORM(_ptr(None if r is None else res), out.data_ptr(),
                 x.data_ptr(), _ptr(r), weight.data_ptr(), x.shape[0],
                 x.shape[1], eps, DTYPE_CODES[x.dtype], plan.vpt,
                 plan.row_threads, plan.rows_per_block, current_stream())
    return res, out


def add_layer_norm_plain(x: torch.Tensor, o: Optional[torch.Tensor],
                         mlp: Optional[torch.Tensor], weight: torch.Tensor,
                         bias: torch.Tensor, eps: float) -> Pair:
    """Plain PyTorch version: ``s = x + (o + mlp)`` in falcon's order
    (``x + o`` without mlp, x itself without o), then ``(s,
    layer_norm(s, weight, bias, eps))``."""
    s = x
    if o is not None:
        s = x + (o if mlp is None else o + mlp)
    return s, layer_norm(s, weight, bias, eps)


def add_layer_norm(x: torch.Tensor, o: Optional[torch.Tensor],
                   mlp: Optional[torch.Tensor], weight: torch.Tensor,
                   bias: torch.Tensor, eps: float) -> Pair:
    """x, o, mlp: [T, H] of the model's dtype (o and mlp None for no
    addend, mlp None for x + o); weight, bias [H].  Returns (x + (o +
    mlp), layer_norm of it), each sum rounded to the dtype; the variance
    is the mean of squared deviations from the mean."""
    if not x.is_cuda:
        return add_layer_norm_plain(x, o, mlp, weight, bias, eps)
    if o is None and mlp is not None:
        raise ValueError("add_layer_norm: mlp without o")
    _check_rows("add_layer_norm", x, (o, mlp), (weight, bias))
    out = torch.empty_like(x)
    res = x if o is None else torch.empty_like(x)
    if x.shape[0] == 0:
        return res, out
    ADD_LAYER_NORM(_ptr(None if o is None else res), out.data_ptr(),
                   x.data_ptr(), _ptr(o), _ptr(mlp), weight.data_ptr(),
                   bias.data_ptr(), x.shape[0], x.shape[1], eps,
                   DTYPE_CODES[x.dtype], current_stream())
    return res, out


def silu_and_mul(x: torch.Tensor) -> torch.Tensor:
    """x: [T, 2I] of the model's dtype -> silu(gate) * up [T, I], silu in
    float32 rounded to the dtype before the product (as the plain
    version)."""
    if not x.is_cuda:
        return silu_and_mul_plain(x)
    check_cuda_tensor("silu_and_mul", x)
    inter = x.shape[-1] // 2 if x.dim() == 2 else 0
    if (x.dtype not in DTYPE_CODES or x.dim() != 2 or x.shape[1] % 2
            or inter == 0 or (inter * x.element_size()) % 16):
        raise ValueError(f"silu_and_mul: x {tuple(x.shape)} of {x.dtype}")
    out = torch.empty((x.shape[0], inter), dtype=x.dtype, device=x.device)
    if x.shape[0] == 0:
        return out
    plan = silu_plan(x.shape[0], inter, x.element_size(),
                     _sm_count(x.device))
    SILU_AND_MUL(out.data_ptr(), x.data_ptr(), x.shape[0], inter,
                 DTYPE_CODES[x.dtype], plan.vpt, plan.threads, plan.tiles,
                 current_stream())
    return out


def gelu_new(x: torch.Tensor) -> torch.Tensor:
    """Falcon's MLP activation: tanh GELU in float32, rounded once to x's
    dtype; x of any shape whose size is a whole number of 16-byte
    vectors."""
    if not x.is_cuda:
        return gelu_new_plain(x)
    check_cuda_tensor("gelu_new", x)
    es = x.element_size()
    if x.dtype not in DTYPE_CODES or (x.numel() * es) % 16:
        raise ValueError(f"gelu_new: x {tuple(x.shape)} of {x.dtype}")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    GELU_NEW(out.data_ptr(), x.data_ptr(), x.numel(), DTYPE_CODES[x.dtype],
             *gelu_plan(x.numel(), es), current_stream())
    return out
