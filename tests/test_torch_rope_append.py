"""Kernel A with the rotation: RoPE + KV append against the JAX package.

``rope_kv_append`` on CPU tensors takes its plain version (the port's
``RotaryEmbedding`` then ``kv_append_plain``).  The same numpy-seeded
qkv rows go through the JAX package's ``get_rope`` and its vattn
backend's ``append_kv`` (``cache_append_run`` for the prefill runs,
``cache_append_tokens`` for the decode slots, Pallas in interpret mode as
tests/test_torch_ops.py runs them, after the backend's head padding and
quantization).  Every rope variant of ``get_rope`` (plain, linear,
dynamic NTK, YaRN), float32 and bfloat16 models, arenas of the model's
dtype and e4m3 and int8, head_dim 128 and 64 (the arena pads the head to
128 with zeros), rows of -1 (prefill padding, idle slots), a decode-only
batch and T = 0.

Tolerances: q and a float32 arena within atol = rtol = 1e-4, as
``test_rope_matches`` (the two frameworks' cos/sin may differ in the
last bit); bfloat16 q and arena values within one bfloat16 ulp (such a
difference can move a bf16 rounding); 1-byte arenas within one step of
the values the arena stores (an int8 step; for e4m3 the next stored
value, where 0 and 2^-6 are neighbours since no denormal is stored), for
a value that rounds differently across the frameworks.  The plain
version must equal the port's rope followed by ``kv_append_plain`` (the
serving path before kernel A rotated) bit for bit.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vattention_tpu.model_executor.attention.vattn_backend import (
    VattnAttentionBackend as JaxBackend)
from vattention_tpu.model_executor.layers.rotary_embedding import (
    get_rope as jax_get_rope)
from vattention_tpu_torch.model_executor.attention.no_op_backend import (
    NoOpAttentionBackend)
from vattention_tpu_torch.model_executor.layers.rotary_embedding import (
    get_rope)
from vattention_tpu_torch.ops.cache_append import (kv_append_plain,
                                                   rope_kv_append,
                                                   rope_kv_append_plain)

L, HQ, HKV = 2, 4, 2
DP = 128          # the arena's head width (head_dim padded to 128)
R = 1024
MAX_POS = 8192
THETA = 5e6
STEP = 0.04       # the int8 step (KV_INT8_SCALE's default)
SCALINGS = {
    "plain": None,
    "linear": {"type": "linear", "factor": 4.0},
    "dynamic": {"type": "dynamic", "factor": 2.0},
    "yarn": {"type": "yarn", "factor": 4.0,
             "original_max_position_embeddings": 4096},
}
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
ARENAS = {"fp8": (torch.float8_e4m3fn, jnp.float8_e4m3fn),
          "int8": (torch.int8, jnp.int8)}

# a mixed step: two prefill runs (rows 37..56 at positions 100..119, rows
# 512..541 at 0..29), 14 padding tokens, then 4 decode slots (one idle)
N_PRE = 64
PRE_RUNS = [(37, 0, 20, 100), (512, 20, 30, 0)]   # row0, tok0, n, pos0
DEC_ROWS = [800, -1, 7, 300]
DEC_POS = [4000, 0, 8191, 57]


def step_layout(decode_only=False):
    """(positions, rows, pre_runs [8, 3], n_prefill_tokens)."""
    pos, rows = [], []
    pre_runs = np.zeros((8, 3), np.int32)
    if not decode_only:
        pos = np.zeros(N_PRE, np.int32)
        rows = np.full(N_PRE, -1, np.int32)
        for i, (row0, tok0, n, pos0) in enumerate(PRE_RUNS):
            pre_runs[i] = (row0, tok0, n)
            pos[tok0:tok0 + n] = np.arange(pos0, pos0 + n)
            rows[tok0:tok0 + n] = np.arange(row0, row0 + n)
    pos = np.concatenate([pos, DEC_POS]).astype(np.int32)
    rows = np.concatenate([rows, DEC_ROWS]).astype(np.int32)
    return pos, rows, pre_runs, 0 if decode_only else N_PRE


def arena_dtypes(arena, dtype):
    return ARENAS[arena] if arena in ARENAS else DTYPES[dtype]


def make_inputs(rng, T, D, dtype, arena):
    """qkv [T, (HQ + 2 HKV) * D] in the model's dtype and a seeded arena
    of the arena's dtype (float32 values quantized as kernel A writes
    them), as numpy arrays the two frameworks share."""
    qkv = (rng.standard_normal((T, (HQ + 2 * HKV) * D)) * 2).astype(
        np.float32)
    qkv = torch.from_numpy(qkv).to(DTYPES[dtype][0])
    cache = torch.from_numpy(
        rng.standard_normal((L, 2, HKV, R, DP)).astype(np.float32))
    if arena == "int8":
        cache = torch.round(cache / STEP).clamp(-127, 127).to(torch.int8)
    else:
        cache = cache.clamp(-448, 448).to(arena_dtypes(arena, dtype)[0])
    return qkv, cache


def to_jax(x: torch.Tensor, jdtype):
    if x.dtype in (torch.bfloat16, torch.float8_e4m3fn):
        return jnp.asarray(x.float().numpy()).astype(jdtype)
    return jnp.asarray(x.numpy())


def jax_reference(qkv, cache, pos, rows, pre_runs, n_pre, layer, D,
                  scaling, dtype, arena):
    """q and the arena after the JAX rope and the JAX backend's append."""
    jdt = DTYPES[dtype][1]
    T = qkv.shape[0]
    x = to_jax(qkv, jdt).reshape(T, HQ + 2 * HKV, D)
    q, k, v = x[:, :HQ], x[:, HQ:HQ + HKV], x[:, HQ + HKV:]
    q, k = jax_get_rope(D, D, MAX_POS, THETA, scaling)(
        jnp.asarray(pos), q, k)
    backend = JaxBackend(block_tokens=256, num_segments=8,
                         max_context_len=R, arena_rows=R,
                         kv_scale=STEP if arena == "int8" else None)
    inputs = SimpleNamespace(append_rows=jnp.asarray(rows),
                             pre_runs=jnp.asarray(pre_runs))
    out = backend.append_kv(to_jax(cache, arena_dtypes(arena, dtype)[1]),
                            k, v, inputs, jnp.asarray([layer], jnp.int32),
                            n_pre)
    return np.asarray(q.astype(jnp.float32)), out


def as_float(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(
        x.astype(jnp.float32))


def assert_within_bf16_ulp(got, expect):
    got, expect = np.asarray(got, np.float32), np.asarray(expect, np.float32)
    mag = np.maximum(np.abs(got), np.abs(expect))
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 2.0 ** -126))) - 7)
    bad = np.abs(got - expect) > ulp
    assert not bad.any(), (f"{bad.sum()} values past one bf16 ulp, e.g. "
                           f"{got[bad][:4]} against {expect[bad][:4]}")


def stored_steps(x: torch.Tensor) -> np.ndarray:
    """Each value of a 1-byte arena as its signed rank among the values
    the arena stores (int8: the integer; e4m3: 0, then 2^-6 = 1, ...: no
    denormal is ever stored)."""
    if x.dtype == torch.int8:
        return x.numpy().astype(np.int32)
    b = x.view(torch.uint8).numpy().astype(np.int32)
    mag = b & 0x7F
    rank = np.where(mag == 0, 0, mag - 7)
    return np.where(b & 0x80, -rank, rank)


def check_against_jax(q, cache, jq, jcache, dtype, arena):
    if dtype == "float32":
        np.testing.assert_allclose(q.numpy(), jq, atol=1e-4, rtol=1e-4)
    else:
        assert_within_bf16_ulp(q.float().numpy(), jq)
    if arena in ARENAS:
        want = torch.from_numpy(np.array(jcache).view(np.uint8)).view(
            cache.dtype)
        diff = np.abs(stored_steps(cache) - stored_steps(want))
        assert diff.max() <= 1, f"{(diff > 1).sum()} values past one step"
    elif dtype == "float32":
        np.testing.assert_allclose(cache.numpy(), np.asarray(jcache),
                                   atol=1e-4, rtol=1e-4)
    else:
        assert_within_bf16_ulp(cache.float().numpy(), as_float(jcache))


def rope_then_kv_append(cache, qkv, pos, rows, layer, rope, kv_scale):
    """The serving path before kernel A rotated: the eager rope on views
    of qkv, then kv_append_plain of contiguous, zero-padded K and V."""
    T, D = qkv.shape[0], rope.head_dim
    q = qkv[:, :HQ * D].reshape(T, HQ, D)
    k = qkv[:, HQ * D:(HQ + HKV) * D].reshape(T, HKV, D)
    v = qkv[:, (HQ + HKV) * D:].reshape(T, HKV, D)
    q, k = rope(pos, q, k)
    pad = torch.nn.functional.pad
    kv_append_plain(cache, pad(k, (0, DP - D)).contiguous(),
                    pad(v, (0, DP - D)).contiguous(), rows, layer, kv_scale)
    return q


@pytest.mark.parametrize("D", [128, 64])
@pytest.mark.parametrize("arena", ["model", "fp8", "int8"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("scaling", list(SCALINGS))
def test_rope_kv_append_matches_jax(scaling, dtype, arena, D):
    rng = np.random.default_rng(11)
    pos, rows, pre_runs, n_pre = step_layout()
    T = len(pos)
    qkv, cache = make_inputs(rng, T, D, dtype, arena)
    kv_scale = STEP if arena == "int8" else None
    rope = get_rope(D, D, MAX_POS, THETA, SCALINGS[scaling])
    jq, jcache = jax_reference(qkv, cache, pos, rows, pre_runs, n_pre, 1, D,
                               SCALINGS[scaling], dtype, arena)
    got = cache.clone()
    q = rope_kv_append(got, qkv, torch.from_numpy(pos),
                       torch.from_numpy(rows), 1, rope, kv_scale)
    assert q.shape == (T, HQ, D) and q.dtype == qkv.dtype
    check_against_jax(q, got, jq, jcache, dtype, arena)
    # rows of -1 and layer 0 untouched; the padding past D is zero
    assert torch.equal(got[0].view(torch.uint8), cache[0].view(torch.uint8))
    written = torch.from_numpy(rows[rows >= 0]).long()
    if D < DP:
        assert not got[1][:, :, written, D:].float().any()
    untouched = torch.ones(R, dtype=torch.bool)
    untouched[written] = False
    assert torch.equal(got[1][:, :, untouched].view(torch.uint8),
                       cache[1][:, :, untouched].view(torch.uint8))


@pytest.mark.parametrize("arena", ["model", "fp8", "int8"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_decode_only_batch_matches_jax(dtype, arena):
    rng = np.random.default_rng(12)
    pos, rows, pre_runs, n_pre = step_layout(decode_only=True)
    qkv, cache = make_inputs(rng, len(pos), 128, dtype, arena)
    rope = get_rope(128, 128, MAX_POS, THETA, None)
    jq, jcache = jax_reference(qkv, cache, pos, rows, pre_runs, n_pre, 0,
                               128, None, dtype, arena)
    got = cache.clone()
    q = rope_kv_append(got, qkv, torch.from_numpy(pos),
                       torch.from_numpy(rows), 0, rope,
                       STEP if arena == "int8" else None)
    check_against_jax(q, got, jq, jcache, dtype, arena)


@pytest.mark.parametrize("D", [128, 64])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("scaling", list(SCALINGS))
def test_plain_is_rope_then_kv_append(scaling, dtype, D):
    """Bit for bit on every arena: the plain version is the port's rope
    followed by kv_append_plain."""
    rng = np.random.default_rng(13)
    pos, rows, _, _ = step_layout()
    rope = get_rope(D, D, MAX_POS, THETA, SCALINGS[scaling])
    for arena in ("model", "fp8", "int8"):
        qkv, cache = make_inputs(rng, len(pos), D, dtype, arena)
        kv_scale = STEP if arena == "int8" else None
        args = (torch.from_numpy(pos), torch.from_numpy(rows), 1, rope,
                kv_scale)
        got, expect = cache.clone(), cache.clone()
        q = rope_kv_append_plain(got, qkv, *args)
        q_ref = rope_then_kv_append(expect, qkv, *args)
        assert torch.equal(q, q_ref)
        assert torch.equal(got.view(torch.uint8), expect.view(torch.uint8))


def test_no_tokens_gives_an_empty_q_and_writes_nothing():
    rng = np.random.default_rng(14)
    qkv, cache = make_inputs(rng, 0, 128, "bfloat16", "model")
    got = cache.clone()
    q = rope_kv_append(got, qkv, torch.zeros(0, dtype=torch.int32),
                       torch.zeros(0, dtype=torch.int32), 1,
                       get_rope(128, 128, MAX_POS, THETA, None))
    assert q.shape == (0, HQ, 128) and q.dtype == torch.bfloat16
    assert torch.equal(got, cache)


def test_int8_arena_needs_a_step():
    rng = np.random.default_rng(15)
    qkv, cache = make_inputs(rng, 4, 128, "float32", "int8")
    rope = get_rope(128, 128, MAX_POS, THETA, None)
    args = (torch.arange(4, dtype=torch.int32),
            torch.arange(4, dtype=torch.int32), 0, rope)
    with pytest.raises(ValueError, match="kv_scale"):
        rope_kv_append(cache, qkv, *args)
    with pytest.raises(ValueError, match="kv_scale"):
        rope_kv_append(cache.float(), qkv, *args, kv_scale=STEP)


def test_no_op_backend_rotates_q_and_writes_nothing():
    rng = np.random.default_rng(16)
    pos, rows, _, _ = step_layout()
    qkv, cache = make_inputs(rng, len(pos), 128, "float32", "model")
    rope = get_rope(128, 128, MAX_POS, THETA, None)
    got = cache.clone()
    inputs = SimpleNamespace(positions=torch.from_numpy(pos),
                             append_rows=torch.from_numpy(rows))
    q = NoOpAttentionBackend().rope_append_kv(got, qkv, rope, inputs, 1)
    assert torch.equal(got, cache)
    assert torch.equal(q, rope_kv_append_plain(cache.clone(), qkv,
                                               inputs.positions,
                                               inputs.append_rows, 1, rope))


@pytest.mark.parametrize("scaling", list(SCALINGS))
def test_kernel_args_reproduce_the_rotation(scaling):
    """What kernel A reads (inverse frequencies, position scale,
    post-scale) gives the rope's cos/sin and scale: the position scale is
    the float32 reciprocal of a linear factor (exact for these factors),
    the post-scale YaRN's mscale, else 1; inv_freq is copied to a device
    once."""
    rope = get_rope(128, 128, MAX_POS, THETA, SCALINGS[scaling])
    dev = torch.device("cpu")
    inv_freq, pos_scale, post_scale = rope.kernel_args(dev)
    assert inv_freq is rope.inv_freq_on(dev)
    assert inv_freq.dtype == torch.float32 and inv_freq.shape == (64,)
    pos = torch.tensor([0, 1, 5, 100, 4000, 8191], dtype=torch.int32)
    cos, sin = rope._cos_sin(pos)
    freqs = (pos.float() * pos_scale)[:, None] * inv_freq[None, :]
    assert torch.equal(cos, torch.cos(freqs))
    assert torch.equal(sin, torch.sin(freqs))
    assert post_scale == getattr(rope, "mscale", 1.0)
