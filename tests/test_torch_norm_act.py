"""The layer's fused elementwise work (``ops/norm_act.py``) and the qkv bias
inside kernel A, against the JAX compositions they replace, on the CPU.

Each plain version takes the same numpy-seeded inputs as the JAX
functions it fuses: ``x + r`` then ``rms_norm``; falcon's ``x + (o +
mlp)`` then its ``layer_norm``; ``silu_and_mul``; ``gelu_new``; in
float32 and bfloat16, at widths 256, 4096 and 4544 (falcon's: 568
16-byte vectors, not a multiple of a warp's) and 1, 7 and 33 rows.  On
CPU tensors each wrapper is its plain version (the kernels run on the
card: tests/test_torch_cuda.py).  ``rope_kv_append_plain`` with a bias
is held against the JAX vattn backend's ``append_kv`` after ``qkv +
qkv_b`` and the JAX rope; the port's llama (with and without a nonzero
qkv bias) and falcon forward logits against the JAX models' on tiny
widths, through ``params_from_jax`` and both no_op backends; and the
residual carried into ``head`` gives the logits of the summed one.

Tolerances: the residual output exactly (both frameworks add two values
of the dtype in float32 and round once); the normalized and activated
outputs within 1e-6 of the output's scale in float32 (the reductions
sum in other orders, and silu is x * sigmoid(x) in JAX, x / (1 +
exp(-x)) in PyTorch), and in bfloat16 within one bfloat16 ulp of each
output (such a difference can move one rounding) or that float32 floor
(LayerNorm's x - mean cancels on values near the mean, where the mean's
last float32 bit is a large share of a small output).  Kernel A's outputs
as in tests/test_torch_rope_append.py; logits within 1e-5.
"""

import re
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_rope_append import (HKV, HQ, MAX_POS, THETA,
                                          arena_dtypes, check_against_jax,
                                          jax_reference, make_inputs,
                                          step_layout)
from vattention_tpu.config import ModelArch as JaxModelArch
from vattention_tpu.model_executor.attention.no_op_backend import \
    NoOpAttentionBackend as JaxNoOp
from vattention_tpu.model_executor.layers.activation import \
    gelu_new as jax_gelu_new
from vattention_tpu.model_executor.layers.activation import \
    silu_and_mul as jax_silu_and_mul
from vattention_tpu.model_executor.layers.layernorm import \
    rms_norm as jax_rms_norm
from vattention_tpu.model_executor.models import \
    get_model_class as jax_model_class
from vattention_tpu.model_executor.models.falcon import \
    layer_norm as jax_layer_norm
from vattention_tpu_torch.config import ModelArch
from vattention_tpu_torch.model_executor.attention.no_op_backend import \
    NoOpAttentionBackend
from vattention_tpu_torch.model_executor.layers.rotary_embedding import \
    get_rope
from vattention_tpu_torch.model_executor.models import get_model_class
from vattention_tpu_torch.microbenchmarks.bench_norm_act import (
    HIDDEN_WIDTHS, MLP_WIDTHS, PLAN_ROWS)
from vattention_tpu_torch.model_executor.weight_utils import params_from_jax
from vattention_tpu_torch.ops import norm_act
from vattention_tpu_torch.ops.cache_append import (rope_kv_append,
                                                   rope_kv_append_plain)

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
WIDTHS = [256, 4096, 4544]
ROWS = [1, 7, 33]
RMS_EPS, LN_EPS = 1e-5, 1e-5


def draw(rng, *shape, scale=1.0, shift=0.0):
    return (rng.standard_normal(shape) * scale + shift).astype(np.float32)


def both(x: np.ndarray, dtype: str):
    """The same values as a torch tensor and a JAX array of ``dtype``."""
    tdt, jdt = DTYPES[dtype]
    return torch.from_numpy(x).to(tdt), jnp.asarray(x, jnp.float32).astype(jdt)


def as_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def assert_close(got, expect, dtype: str):
    """Within 1e-6 of the output's scale (float32), or within one bf16
    ulp of each output or that float32 floor (bfloat16)."""
    got, expect = as_np(got), as_np(expect)
    assert got.shape == expect.shape
    floor = 1e-6 * float(np.abs(expect).max())
    if dtype == "float32":
        np.testing.assert_allclose(got, expect, rtol=1e-6, atol=floor)
        return
    mag = np.maximum(np.abs(got), np.abs(expect))
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 2.0 ** -126))) - 7)
    bad = np.abs(got - expect) > np.maximum(ulp, floor)
    assert not bad.any(), (f"{bad.sum()} values past one bf16 ulp, e.g. "
                           f"{got[bad][:4]} against {expect[bad][:4]}")


def assert_exact(got, expect):
    np.testing.assert_array_equal(as_np(got), as_np(expect))


# ---------------------------------------------------------------------- #
# the plain versions against the JAX compositions
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("addend", ["residual", "none"])
def test_add_rms_norm_matches_jax(addend, dtype, width, rows):
    """``add_rms_norm`` against the JAX layer's ``x = x + o`` then
    ``rms_norm(x)``; with no addend, the plain norm (layer 0's input
    norm) and the residual is x itself."""
    rng = np.random.default_rng(width + rows)
    x, jx = both(draw(rng, rows, width, scale=2, shift=0.5), dtype)
    r, jr = both(draw(rng, rows, width, scale=0.7), dtype)
    w, jw = both(draw(rng, width, scale=0.2, shift=1), dtype)
    if addend == "none":
        r, js = None, jx
    else:
        js = jx + jr
    res, out = norm_act.add_rms_norm_plain(x, r, w, RMS_EPS)
    assert res.dtype == out.dtype == x.dtype
    assert_exact(res, js)
    if r is None:
        assert res is x
    assert_close(out, jax_rms_norm(js, jw, RMS_EPS), dtype)


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("addend", ["o_mlp", "none"])
def test_add_layer_norm_matches_jax(addend, dtype, width, rows):
    """``add_layer_norm`` against falcon's ``x = x + (o + mlp)`` then its
    ``layer_norm`` (two-pass variance, a bias); with no addend, the plain
    LayerNorm.  Rows with a large mean (shift 3) make a one-pass variance
    cancel."""
    rng = np.random.default_rng(2 * width + rows)
    x, jx = both(draw(rng, rows, width, scale=2, shift=3), dtype)
    o, jo = both(draw(rng, rows, width, scale=0.5), dtype)
    m, jm = both(draw(rng, rows, width, scale=0.5), dtype)
    w, jw = both(draw(rng, width, scale=0.2, shift=1), dtype)
    b, jb = both(draw(rng, width, scale=0.1), dtype)
    if addend == "none":
        o = m = None
        js = jx
    else:
        js = jx + (jo + jm)
    res, out = norm_act.add_layer_norm_plain(x, o, m, w, b, LN_EPS)
    assert res.dtype == out.dtype == x.dtype
    assert_exact(res, js)
    assert_close(out, jax_layer_norm(js, jw, jb, LN_EPS), dtype)


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_silu_and_mul_matches_jax(dtype, width, rows):
    """[rows, 2 * width] -> [rows, width] against the JAX ``silu_and_mul``
    (gate values to +-12, past where silu saturates)."""
    rng = np.random.default_rng(3 * width + rows)
    x, jx = both(draw(rng, rows, 2 * width, scale=4), dtype)
    out = norm_act.silu_and_mul_plain(x)
    assert out.dtype == x.dtype and out.shape == (rows, width)
    assert_close(out, jax_silu_and_mul(jx), dtype)


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_gelu_new_matches_jax(dtype, width, rows):
    """Falcon's MLP activation (4 x the width in the model; here the
    width itself) against the JAX ``gelu_new``."""
    rng = np.random.default_rng(4 * width + rows)
    x, jx = both(draw(rng, rows, width, scale=3), dtype)
    out = norm_act.gelu_new_plain(x)
    assert out.dtype == x.dtype and out.shape == x.shape
    assert_close(out, jax_gelu_new(jx), dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_wrappers_take_the_plain_version_on_cpu_tensors(dtype):
    """Each wrapper on CPU tensors gives its plain version's bits; the
    residual is x itself without an addend."""
    tdt = DTYPES[dtype][0]
    rng = np.random.default_rng(5)
    x, r, o = (torch.from_numpy(draw(rng, 7, 256)).to(tdt) for _ in range(3))
    w, b = (torch.from_numpy(draw(rng, 256)).to(tdt) for _ in range(2))
    pairs = [
        (norm_act.add_rms_norm(x, r, w, RMS_EPS),
         norm_act.add_rms_norm_plain(x, r, w, RMS_EPS)),
        (norm_act.add_rms_norm(x, None, w, RMS_EPS),
         norm_act.add_rms_norm_plain(x, None, w, RMS_EPS)),
        (norm_act.add_layer_norm(x, r, o, w, b, LN_EPS),
         norm_act.add_layer_norm_plain(x, r, o, w, b, LN_EPS)),
        (norm_act.add_layer_norm(x, r, None, w, b, LN_EPS),
         norm_act.add_layer_norm_plain(x, r, None, w, b, LN_EPS)),
        ((norm_act.silu_and_mul(torch.cat([x, r], 1)),),
         (norm_act.silu_and_mul_plain(torch.cat([x, r], 1)),)),
        ((norm_act.gelu_new(x),), (norm_act.gelu_new_plain(x),)),
    ]
    for got, expect in pairs:
        for g, e in zip(got, expect):
            assert torch.equal(g, e)
    assert norm_act.add_rms_norm(x, None, w, RMS_EPS)[0] is x
    assert norm_act.add_layer_norm(x, None, None, w, b, LN_EPS)[0] is x


# ---------------------------------------------------------------------- #
# the launch plans of add_rms_norm and silu_and_mul (the kernels run on the
# card; each plan's index map is the kernel's, written out here)
# ---------------------------------------------------------------------- #
SOURCE = Path(norm_act.__file__).resolve().parents[1] / "csrc" / "norm_act.cu"
ELEMENT_SIZES = {"float32": 4, "bfloat16": 2}


def source_constant(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);",
                         SOURCE.read_text()).group(1))


def test_plan_limits_are_the_sources():
    assert (norm_act.MAX_VECS, norm_act.NORM_THREADS, norm_act.MAX_ACT_VECS,
            norm_act.ACT_THREADS, norm_act.MAX_ACT_TILES,
            norm_act.MAX_GELU_VECS) == tuple(
        source_constant(n) for n in ("kMaxVecs", "kNormThreads",
                                     "kMaxActVecs", "kActThreads",
                                     "kMaxActTiles", "kMaxGeluVecs"))


def test_plan_widths_are_the_registrys():
    from vattention_tpu_torch.config import _ARCH_REGISTRY

    archs = _ARCH_REGISTRY.values()
    assert HIDDEN_WIDTHS == tuple(sorted({a.hidden_size for a in archs}))
    assert MLP_WIDTHS == tuple(sorted({a.intermediate_size for a in archs}))


@pytest.mark.parametrize("dtype", list(ELEMENT_SIZES))
@pytest.mark.parametrize("width", HIDDEN_WIDTHS)
def test_norm_plan_covers_each_row_once(width, dtype):
    """At every T of PLAN_ROWS, on cards of 1 and 132 SMs: block b's row
    group g takes row b * rows_per_block + g, its thread t the row's
    vectors t + i * row_threads (i < vpt), as add_rms_norm_kernel does;
    every row and every vector of it is taken once, no block and no warp
    of a row is left without work, and the plan keeps the source's limits
    (vectors a thread, threads a block, 15 named barriers)."""
    es = ELEMENT_SIZES[dtype]
    nvec = width * es // 16
    for sms in (1, 132):
        for T in PLAN_ROWS:
            p = norm_act.norm_plan(T, width, es, sms)
            assert p.vpt in (1, 2, 4, norm_act.MAX_VECS)
            assert p.row_threads % 32 == 0
            assert p.row_threads * p.rows_per_block <= norm_act.NORM_THREADS
            assert p.row_threads == 32 or p.rows_per_block <= 15
            assert p.row_threads * p.vpt >= nvec > (p.row_threads - 32) * p.vpt
            rows = (np.arange(p.blocks)[:, None] * p.rows_per_block
                    + np.arange(p.rows_per_block)).ravel()
            assert np.array_equal(rows[rows < T], np.arange(T))
            assert (p.blocks - 1) * p.rows_per_block < T
            cols = (np.arange(p.row_threads)[:, None]
                    + np.arange(p.vpt) * p.row_threads).ravel()
            assert np.array_equal(np.sort(cols[cols < nvec]),
                                  np.arange(nvec))


@pytest.mark.parametrize("dtype", list(ELEMENT_SIZES))
@pytest.mark.parametrize("inter", MLP_WIDTHS)
def test_silu_plan_covers_each_row_once(inter, dtype):
    """At every T of PLAN_ROWS, on cards of 1 and 132 SMs: block (row, y)'s
    thread t takes the row's output vectors y * threads * vpt + i *
    threads + t (i < vpt), as silu_and_mul_kernel does; every vector of a
    row is taken once, no tile is left without work, and the plan keeps
    the source's limits."""
    es = ELEMENT_SIZES[dtype]
    per_row = inter * es // 16
    for sms in (1, 132):
        for T in PLAN_ROWS:
            p = norm_act.silu_plan(T, inter, es, sms)
            assert p.vpt in (1, norm_act.MAX_ACT_VECS)
            assert p.threads % 32 == 0
            assert 0 < p.threads <= norm_act.ACT_THREADS
            assert 1 <= p.tiles <= norm_act.MAX_ACT_TILES
            tile = p.threads * p.vpt
            assert tile * p.tiles >= per_row > tile * (p.tiles - 1)
            cols = (np.arange(p.tiles)[:, None, None] * tile
                    + np.arange(p.vpt)[:, None] * p.threads
                    + np.arange(p.threads)).ravel()
            assert np.array_equal(np.sort(cols[cols < per_row]),
                                  np.arange(per_row))


# gelu_new's widths: falcon-7b's MLP (the registry's only gelu width),
# the tiny falcons' of the tests, and the CPU tests' of gelu_new
GELU_WIDTHS = (256, 1024, 4544, 18176)


@pytest.mark.parametrize("dtype", list(ELEMENT_SIZES))
@pytest.mark.parametrize("width", GELU_WIDTHS)
def test_gelu_plan_covers_each_vector_once(width, dtype):
    """At every T of PLAN_ROWS: block b's thread t takes the flat
    tensor's vectors b * threads * vpt + i * threads + t (i < vpt), as
    gelu_new_kernel does; every vector is taken once, no block is left
    without work, and the plan keeps the source's limits."""
    es = ELEMENT_SIZES[dtype]
    for T in PLAN_ROWS:
        n_vec = T * width * es // 16
        p = norm_act.gelu_plan(T * width, es)
        assert p.vpt in (1, 2, norm_act.MAX_GELU_VECS)
        assert p.threads % 32 == 0
        assert 0 < p.threads <= norm_act.ACT_THREADS
        tile = p.threads * p.vpt
        assert tile * p.blocks >= n_vec > tile * (p.blocks - 1)
        assert n_vec <= norm_act.GELU_MAX_VECTORS
        vecs = (np.arange(p.blocks)[:, None, None] * tile
                + np.arange(p.vpt)[:, None] * p.threads
                + np.arange(p.threads)).ravel()
        assert np.array_equal(np.sort(vecs[vecs < n_vec]), np.arange(n_vec))


@pytest.mark.parametrize("shape,dtype,whole", [
    ((2048, 18176), "bfloat16", True),    # falcon's chunk
    ((1, 18176), "float32", True),
    ((3, 5, 1024), "bfloat16", True),     # rows of any rank
    ((4, 6), "float32", True),            # rows of 1.5 vectors
    ((5, 3, 16), "bfloat16", True),
    ((7, 3), "float32", False),           # 84 bytes
])
def test_gelu_plan_takes_any_shape_of_whole_vectors(shape, dtype, whole):
    """The plan needs only the size: x of any shape whose values fill whole
    16-byte vectors is taken (one block at least), any other refused."""
    es = ELEMENT_SIZES[dtype]
    numel = int(np.prod(shape))
    if not whole:
        with pytest.raises(ValueError):
            norm_act.gelu_plan(numel, es)
        return
    p = norm_act.gelu_plan(numel, es)
    assert p.blocks * p.threads * p.vpt >= numel * es // 16 > 0


@pytest.mark.parametrize("plan", ["norm", "silu"])
def test_plans_refuse_what_the_kernels_do_not_take(plan):
    """Widths that are not whole 16-byte vectors, negative rows, a norm row
    past MAX_ROW_BYTES and silu rows past MAX_ACT_TILES tiles raise."""
    fn = norm_act.norm_plan if plan == "norm" else norm_act.silu_plan
    for width, es in ((4100, 2), (4098, 4), (7, 2), (0, 2), (-8, 2)):
        with pytest.raises(ValueError):
            fn(8, width, es, 132)
    with pytest.raises(ValueError):
        fn(-1, 4096, 2, 132)
    too_wide = (norm_act.MAX_ROW_BYTES // 2 + 8 if plan == "norm"
                else 8 * norm_act.ACT_BLOCK * norm_act.MAX_ACT_VECS
                * (norm_act.MAX_ACT_TILES + 1))
    with pytest.raises(ValueError):
        fn(8, too_wide, 2, 132)


def test_gelu_plan_refuses_what_the_kernel_does_not_take():
    """Sizes that are not whole 16-byte vectors, none, negative ones and
    more vectors than the kernel's 32-bit indices reach raise."""
    for numel, es in ((4100, 2), (4098, 4), (7, 2), (0, 2), (-8, 2)):
        with pytest.raises(ValueError):
            norm_act.gelu_plan(numel, es)
    with pytest.raises(ValueError):
        norm_act.gelu_plan((norm_act.GELU_MAX_VECTORS + 1) * 8, 2)
    norm_act.gelu_plan(norm_act.GELU_MAX_VECTORS * 8, 2)


# ---------------------------------------------------------------------- #
# the qkv bias inside kernel A
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("arena", ["model", "fp8", "int8"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_rope_kv_append_with_bias_matches_jax(dtype, arena):
    """``rope_kv_append`` (its plain version on CPU tensors) with a bias
    against the JAX step's ``qkv + qkv_b``, its rope, then its vattn
    backend's ``append_kv`` (a mixed step: two prefill runs, padding, and
    decode slots with an idle one)."""
    D = 128
    rng = np.random.default_rng(12)
    pos, rows, pre_runs, n_pre = step_layout()
    qkv, cache = make_inputs(rng, len(pos), D, dtype, arena)
    bias = torch.from_numpy(draw(rng, (HQ + 2 * HKV) * D, scale=2)).to(
        qkv.dtype)
    kv_scale = 0.04 if arena == "int8" else None
    rope = get_rope(D, D, MAX_POS, THETA, None)
    got = cache.clone()
    q = rope_kv_append(got, qkv, torch.from_numpy(pos),
                       torch.from_numpy(rows), 1, rope, kv_scale, bias=bias)
    jdt = DTYPES[dtype][1]
    biased = jnp.asarray(qkv.float().numpy()).astype(jdt) + jnp.asarray(
        bias.float().numpy()).astype(jdt)
    jq, jcache = jax_reference(
        torch.from_numpy(np.array(biased.astype(jnp.float32))).to(
            qkv.dtype), cache, pos, rows, pre_runs, n_pre, 1, D, None,
        dtype, arena)
    check_against_jax(q.reshape(len(pos), HQ, D), got, jq, jcache, dtype,
                      arena)
    assert arena_dtypes(arena, dtype)[0] == got.dtype


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_the_bias_is_added_once_before_the_rotation(dtype):
    """The plain version with a bias equals it without one on ``qkv +
    bias`` bit for bit (q and arena), and the no_op backend adds the bias
    the same way before its rope."""
    D = 128
    rng = np.random.default_rng(13)
    pos, rows, _, _ = step_layout()
    qkv, cache = make_inputs(rng, len(pos), D, dtype, "model")
    bias = torch.from_numpy(draw(rng, (HQ + 2 * HKV) * D)).to(qkv.dtype)
    rope = get_rope(D, D, MAX_POS, THETA, None)
    p, rw = torch.from_numpy(pos), torch.from_numpy(rows)
    a, b = cache.clone(), cache.clone()
    qa = rope_kv_append_plain(a, qkv, p, rw, 0, rope, bias=bias)
    qb = rope_kv_append_plain(b, qkv + bias, p, rw, 0, rope)
    assert torch.equal(qa, qb) and torch.equal(a, b)
    assert not torch.equal(qa, rope_kv_append_plain(cache.clone(), qkv, p,
                                                    rw, 0, rope))
    inputs = types.SimpleNamespace(positions=p)
    qn = NoOpAttentionBackend().rope_append_kv(cache, qkv, rope, inputs, 0,
                                               bias=bias)
    assert torch.equal(qn, qa)


# ---------------------------------------------------------------------- #
# the models: the residual carried through the layer loop
# ---------------------------------------------------------------------- #
LLAMA = dict(num_layers=2, num_q_heads=4, num_kv_heads=2, head_dim=128,
             hidden_size=256, intermediate_size=688, vocab_size=2048,
             max_position_embeddings=8192)
FALCON = dict(num_layers=2, num_q_heads=71, num_kv_heads=1, head_dim=64,
              hidden_size=256, intermediate_size=1024, vocab_size=2048,
              max_position_embeddings=2048, parallel_attn=True)


def tiny(family: str, qkv_bias: bool):
    kw = FALCON if family == "falcon" else dict(LLAMA, qkv_bias=qkv_bias)
    model_type = "falcon" if family == "falcon" else (
        "qwen" if qkv_bias else "llama")
    return JaxModelArch(model_type, **kw), ModelArch(model_type, **kw)


def seeded_params(jmodel, rng):
    """The JAX init's weights with norms, norm biases and the qkv bias
    drawn nonzero (the init leaves them ones and zeros)."""
    def redraw(tree):
        out = dict(tree)
        for name, v in tree.items():
            if name.endswith("norm"):
                out[name] = jnp.asarray(
                    1 + 0.1 * rng.standard_normal(v.shape), jnp.float32)
            elif name.endswith("_b"):
                out[name] = jnp.asarray(0.5 * rng.standard_normal(v.shape),
                                        jnp.float32)
        return out

    jp = redraw(jmodel.init_params(np.random.default_rng(7)))
    return dict(jp, layers=redraw(jp["layers"]))


@pytest.mark.parametrize("family,qkv_bias", [("llama", False),
                                             ("llama", True),
                                             ("falcon", False)])
def test_forward_matches_jax(family, qkv_bias):
    """The port's forward (every norm, residual add and activation through
    the wrappers, the bias through ``rope_append_kv``) against the JAX
    model's on the same weights and 37 tokens, both through their no_op
    backends: float32 logits of 3 sampled rows within 1e-5.  The residual
    carried into ``head`` gives the logits of ``run_layers``' summed
    residual bit for bit (a pipeline stage hands on the summed one)."""
    jarch, arch = tiny(family, qkv_bias)
    jmodel = jax_model_class(jarch.model_type)(jarch, dtype=jnp.float32,
                                               tp_size=1)
    rng = np.random.default_rng(8)
    jp = seeded_params(jmodel, rng)
    T = 37
    ids = rng.integers(1, 2048, T).astype(np.int32)
    sample = np.array([0, 20, T - 1], np.int32)
    D, L, hkv = arch.head_dim, arch.num_layers, arch.num_kv_heads
    jin = types.SimpleNamespace(token_ids=jnp.asarray(ids),
                                positions=jnp.arange(T, dtype=jnp.int32),
                                sample_idx=jnp.asarray(sample))
    _, expect = jmodel.forward(jp, jnp.zeros((L, 2, hkv, 8, D)), jin,
                               JaxNoOp(), T)

    model = get_model_class(arch.model_type)(arch, dtype=torch.float32)
    params = params_from_jax(jax.tree.map(np.asarray, jp))
    assert ("qkv_b" in params["layers"]) == qkv_bias
    pin = types.SimpleNamespace(token_ids=torch.from_numpy(ids).long(),
                                positions=torch.arange(T, dtype=torch.int32),
                                sample_idx=torch.from_numpy(sample))
    cache = torch.zeros((L, 2, hkv, 8, D))
    backend = NoOpAttentionBackend()
    got = model.forward(params, cache, pin, backend, T)
    assert got.dtype == torch.float32 and got.shape == (3, 2048)
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), atol=1e-5,
                               rtol=1e-5)
    x = model.run_layers(params, cache, model.embed(params, pin.token_ids),
                         pin, backend, T)
    assert torch.equal(model.head(params, x, pin.sample_idx), got)


def test_bench_norm_act_on_the_cpu(capsys):
    """The call-by-call harness of the four kernels with ``--device cpu``:
    each case held against its plain version, then one line of min /
    median / max times (the kernel, its plain version, a copy of its
    bytes, a copy of 16 bytes, the library call) for each model, dtype, T
    and kernel."""
    from vattention_tpu_torch.microbenchmarks import bench_norm_act

    assert bench_norm_act.main(["--device", "cpu", "--model", "yi-6b-200k",
                                "falcon-7b", "--rows", "1", "8", "--calls",
                                "2"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("kernel,model,dtype,T")
    rows = [line.split(",") for line in lines[1:]]
    assert len(rows) == 2 * 2 * 2 * 2
    assert {r[0] for r in rows} == {"add_rms_norm", "silu_and_mul",
                                    "add_layer_norm", "gelu_new"}
    assert all(len(r) == 10 and all(len(r[i].split(" / ")) == 3
                                    for i in (4, 5, 7, 8, 9)) for r in rows)
    with pytest.raises(ValueError):
        bench_norm_act.main(["--device", "cpu", "--plans"])
    # the plans it would time are the ones the source takes, the wrapper's
    # among them
    for name, width, es in (("add_rms_norm", 5120, 2),
                            ("silu_and_mul", 11008, 4),
                            ("gelu_new", 18176, 2)):
        for T in (1, 2048):
            got = list(bench_norm_act.plans(name, T, width, es))
            plan = bench_norm_act.PLAN_OF[name](T, width, es, 132)
            assert tuple(plan)[:3] in got
            assert len(set(got)) == len(got) > 1
