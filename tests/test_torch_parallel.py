"""Tensor and pipeline parallelism in the PyTorch port, against the JAX mesh.

The JAX package runs tp and pp on a virtual 8-device CPU mesh inside one
process; the port runs each rank as a process of its own (gloo on the
CPU), started through ``python -m vattention_tpu_torch.parallel.multihost``
(``run_ranks``).  The weight split, the arena's split and the microbatch
splits must equal JAX's bit for bit; a tp=2 forward must give the JAX
``shard_map`` forward's logits (float32, atol = rtol = 2e-3); a pp=2
forward in 2 microbatches the single-device forward's logits within 2e-2
with the same argmax, and its arena rows within 1e-3, as the JAX test
holds its own; and the engine, called from one process at every pp x tp
in {1, 2}^2, the JAX engine's greedy tokens (the JAX engine served once,
its weights carried across in a safetensors checkpoint).

The rank functions here import no JAX: a rank imports this module.
"""

import types

import numpy as np
import pytest
import torch

from vattention_tpu_torch.config import ModelArch, get_model_arch
from vattention_tpu_torch.model_executor.attention.vattn_backend import (
    VattnAttentionBackend)
from vattention_tpu_torch.model_executor.model_runner import ModelRunner
from vattention_tpu_torch.model_executor.models.falcon import (
    FalconForCausalLM)
from vattention_tpu_torch.model_executor.models.llama import LlamaForCausalLM
from vattention_tpu_torch.model_executor.step_inputs import StepInputs
from vattention_tpu_torch.model_executor.weight_utils import params_from_jax
from vattention_tpu_torch.ops.utils import tile_rows_from_segments
from vattention_tpu_torch.parallel.mesh import (ServingMesh, mesh_coords,
                                                mesh_rank, pick_backend,
                                                ranks_per_device)
from vattention_tpu_torch.parallel.multihost import run_ranks
from vattention_tpu_torch.parallel.pipeline import (pipeline_stage_step,
                                                    split_microbatches,
                                                    split_mixed_microbatches)
from vattention_tpu_torch.parallel.sharding import (ShardLayout,
                                                    kv_cache_shape,
                                                    llama_param_specs,
                                                    regroup_gate_up_for_tp,
                                                    regroup_qkv_for_tp,
                                                    shard_params)

# heads and widths that divide over tp 4 (tiny-llama-debug has 2 kv heads)
WIDE = dict(num_layers=4, num_q_heads=8, num_kv_heads=4, head_dim=32,
            hidden_size=64, intermediate_size=96, vocab_size=64,
            max_position_embeddings=1024)


def jax_mesh_shards(x, spec, tp, pp):
    """{(pp, tp): numpy shard} of ``x`` placed by the JAX mesh."""
    import jax
    from jax.sharding import NamedSharding

    from vattention_tpu.parallel.mesh import make_serving_mesh

    mesh = make_serving_mesh(tensor_parallel_size=tp,
                             pipeline_parallel_size=pp)
    arr = jax.device_put(x, NamedSharding(mesh, spec))
    by_device = {s.device: np.asarray(s.data) for s in arr.addressable_shards}
    return {(p, t): by_device[mesh.devices[0, p, t]]
            for p in range(pp) for t in range(tp)}


# --------------------------------------------------------------------- #
# the mesh's arithmetic and the backend rule
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("tp,pp,dp", [(2, 1, 1), (1, 2, 1), (2, 2, 1),
                                      (4, 2, 1), (2, 2, 2)])
def test_mesh_coordinates_equal_jax(tp, pp, dp):
    """Rank r sits where device r sits in the JAX (dp, pp, tp) mesh."""
    import jax

    from vattention_tpu.parallel.mesh import make_serving_mesh

    mesh = make_serving_mesh(tensor_parallel_size=tp,
                             pipeline_parallel_size=pp,
                             data_parallel_size=dp)
    ids = {d.id: i for i, d in enumerate(jax.devices())}
    for d in range(dp):
        for p in range(pp):
            for t in range(tp):
                r = ids[mesh.devices[d, p, t].id]
                assert mesh_rank(d, p, t, tp, pp) == r
                assert mesh_coords(r, tp, pp) == (d, p, t)


def test_backend_rule():
    """nccl only when every rank owns a CUDA device."""
    assert pick_backend("cuda", 1) == "nccl"
    assert pick_backend("cuda", 2) == "gloo"
    assert pick_backend("cpu", 1) == "gloo"
    assert ranks_per_device(4, "cuda", device_count=1) == 4
    assert ranks_per_device(4, "cuda", device_count=4) == 1
    assert ranks_per_device(2, "cpu") == 2
    assert pick_backend("cuda", ranks_per_device(4, "cuda", 4)) == "nccl"
    assert pick_backend("cuda", ranks_per_device(2, "cuda", 1)) == "gloo"


# --------------------------------------------------------------------- #
# the weight split
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("tp", [2, 4])
def test_regroup_equals_jax(tp):
    from vattention_tpu.parallel.sharding import (
        regroup_gate_up_for_tp as jax_gate_up, regroup_qkv_for_tp as jax_qkv)

    rng = np.random.default_rng(tp)
    hq, hkv, d = 8, 4, 16
    qkv = rng.standard_normal((3, 24, (hq + 2 * hkv) * d)).astype(np.float32)
    gate_up = rng.standard_normal((3, 24, 2 * 40)).astype(np.float32)
    got = regroup_qkv_for_tp(torch.from_numpy(qkv), hq, hkv, d, tp)
    assert np.array_equal(got.numpy(),
                          np.asarray(jax_qkv(qkv, hq, hkv, d, tp)))
    got = regroup_gate_up_for_tp(torch.from_numpy(gate_up), tp)
    assert np.array_equal(got.numpy(), np.asarray(jax_gate_up(gate_up, tp)))


@pytest.mark.parametrize("qkv_bias,tie", [(False, False), (True, True)])
def test_param_specs_equal_jax(qkv_bias, tie):
    from vattention_tpu.parallel.sharding import (
        kv_cache_spec, llama_param_specs as jax_specs)

    for tp_axis, pp_axis in (("tp", None), (None, "pp"), ("tp", "pp")):
        want = jax_specs(tp_axis, pp_axis, qkv_bias, tie)
        got = llama_param_specs(tp_axis, pp_axis, qkv_bias, tie)
        assert set(got) == set(want)
        assert set(got["layers"]) == set(want["layers"])
        for k in got:
            if k != "layers":
                assert got[k] == tuple(want[k]), k
        for k in got["layers"]:
            assert got["layers"][k] == tuple(want["layers"][k]), k
    assert tuple(kv_cache_spec("tp", "pp")) == ("pp", None, "tp", None, None)


@pytest.mark.parametrize("tp,pp", [(2, 1), (4, 1), (2, 2), (4, 2)])
def test_shard_params_equal_jax_shards(tp, pp):
    """Every rank's params equal the shard the JAX mesh places on its
    device (the JAX runner's regroup, then ``llama_param_specs``), and the
    rank-local arena shape the JAX ``kv_cache_spec``'s block."""
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from vattention_tpu.config import ModelArch as JaxArch
    from vattention_tpu.model_executor.models.llama import (
        LlamaForCausalLM as JaxLlama)
    from vattention_tpu.parallel.sharding import (
        kv_cache_spec, llama_param_specs as jax_specs,
        regroup_gate_up_for_tp as jax_gate_up, regroup_qkv_for_tp as jax_qkv)

    jarch = JaxArch("llama", **WIDE)
    arch = ModelArch("llama", **WIDE)
    full = JaxLlama(jarch, dtype=jnp.float32).init_params(
        np.random.default_rng(7))
    np_full = {k: (v if k != "layers" else dict(v))
               for k, v in full.items()}
    placed = dict(np_full)
    placed["layers"] = dict(np_full["layers"])
    placed["layers"]["qkv_w"] = jax_qkv(
        np_full["layers"]["qkv_w"], arch.num_q_heads, arch.num_kv_heads,
        arch.head_dim, tp)
    placed["layers"]["gate_up_w"] = jax_gate_up(
        np_full["layers"]["gate_up_w"], tp)
    specs = jax_specs("tp", "pp")
    want = {}
    for k, v in placed.items():
        if k == "layers":
            for n, w in v.items():
                want[f"layers.{n}"] = jax_mesh_shards(w, specs["layers"][n],
                                                      tp, pp)
        else:
            want[k] = jax_mesh_shards(v, P(*specs[k]), tp, pp)
    port_full = params_from_jax({
        k: (np.asarray(v) if k != "layers"
            else {n: np.asarray(w) for n, w in v.items()})
        for k, v in full.items()})
    for p in range(pp):
        for t in range(tp):
            got = shard_params(port_full, arch, ShardLayout(tp, t, pp, p))
            for name, shards in want.items():
                g = (got["layers"][name[len("layers."):]]
                     if name.startswith("layers.") else got[name])
                assert np.array_equal(g.numpy(), shards[(p, t)]), (
                    name, p, t)
    cache = np.zeros((WIDE["num_layers"], 2, WIDE["num_kv_heads"], 8, 4),
                     np.float32)
    block = jax_mesh_shards(cache, kv_cache_spec("tp", "pp"), tp, pp)[0, 0]
    assert kv_cache_shape(WIDE["num_layers"], WIDE["num_kv_heads"], 8, 4,
                          ShardLayout(tp, 0, pp, 0)) == block.shape


def test_unsupported_splits_raise():
    """The kv heads must divide over tp (the JAX model's other case,
    ``tp % num_kv_heads == 0``, splits a head's dimensions), and falcon
    runs on one rank only, as on the JAX mesh."""
    arch = get_model_arch("tiny-llama-debug")  # 4 q heads, 2 kv heads
    with pytest.raises(ValueError, match="num_kv_heads % tp"):
        LlamaForCausalLM(arch, dtype=torch.float32,
                         mesh=types.SimpleNamespace(tp_size=4, tp_rank=0,
                                                    pp_size=1, pp_rank=0))
    falcon = ModelArch("falcon", num_layers=2, num_q_heads=4, num_kv_heads=1,
                       head_dim=64, hidden_size=256, intermediate_size=1024,
                       vocab_size=2048, max_position_embeddings=2048,
                       parallel_attn=True)
    for tp, pp in ((2, 1), (1, 2)):
        with pytest.raises(NotImplementedError, match="falcon"):
            FalconForCausalLM(falcon, dtype=torch.float32,
                              mesh=types.SimpleNamespace(
                                  tp_size=tp, tp_rank=0, pp_size=pp,
                                  pp_rank=0))


@pytest.mark.parametrize("tp,pp", [(2, 1), (1, 2), (2, 2)])
def test_dummy_weights_are_the_one_rank_models_shards(tp, pp):
    """``load_format="dummy"``: every rank draws every layer as the one-rank
    model does and keeps its shard."""
    arch = ModelArch("llama", **WIDE)
    one = LlamaForCausalLM(arch, dtype=torch.float32).init_params(
        torch.device("cpu"), seed=3)
    for p in range(pp):
        for t in range(tp):
            mesh = types.SimpleNamespace(tp_size=tp, tp_rank=t, pp_size=pp,
                                         pp_rank=p)
            got = LlamaForCausalLM(arch, dtype=torch.float32,
                                   mesh=mesh).init_params(
                torch.device("cpu"), seed=3)
            want = shard_params(one, arch, ShardLayout(tp, t, pp, p))
            for k in ("embed", "final_norm", "lm_head"):
                assert torch.equal(got[k], want[k])
            for k, w in want["layers"].items():
                assert torch.equal(got["layers"][k], w), (k, p, t)


# --------------------------------------------------------------------- #
# the microbatch splits
# --------------------------------------------------------------------- #
def split_case(seed=0, B=4, n_pre=256, K=4, S=8, n_sub=4):
    """Host arrays of a mixed step (both packages' fields)."""
    rng = np.random.default_rng(seed)
    T = n_pre + B
    sample_idx = np.array([n_pre + 0, 99, -1, n_pre + 3], np.int32)[:B]
    return dict(
        token_ids=rng.integers(1, 2000, T).astype(np.int32),
        positions=rng.integers(0, 500, T).astype(np.int32),
        append_rows=rng.integers(-1, 1000, T).astype(np.int32),
        pre_seg_row=rng.integers(0, 9, (K + 1, S)).astype(np.int32),
        pre_seg_cum=rng.integers(0, 9, (K + 1, S + 1)).astype(np.int32),
        pre_qinfo=rng.integers(0, 500, (K + 1, 2)).astype(np.int32),
        dec_seg_row=rng.integers(0, 9, (B, S)).astype(np.int32),
        dec_seg_cum=rng.integers(0, 9, (B, S + 1)).astype(np.int32),
        dec_seqlens=rng.integers(0, 500, B).astype(np.int32),
        sample_idx=sample_idx,
        temperatures=rng.random(B).astype(np.float32),
        top_p=rng.random(B).astype(np.float32),
        top_k=rng.integers(-1, 50, B).astype(np.int32),
        qt_run=rng.integers(0, 4, (n_pre // 128, 2)).astype(np.int32),
        pre_tile_rows=rng.integers(0, 999, (K + 1, n_sub)).astype(np.int32),
        dec_tile_rows=rng.integers(0, 999, (B, n_sub)).astype(np.int32),
        pre_runs=np.array([[0, 0, 100], [300, 100, 28], [700, 128, 90],
                           [0, 0, 0]], np.int32))


PORT_FIELDS = [f for f in StepInputs._fields if f != "pod"]


def port_inputs(case, decode_only):
    keep = [f for f in PORT_FIELDS if f in case]
    if decode_only:
        keep = [f for f in keep if f not in ("qt_run", "pre_tile_rows")]
    return StepInputs(**{f: torch.from_numpy(case[f]) for f in keep})


def jax_inputs(case, decode_only):
    import jax
    import jax.numpy as jnp

    from vattention_tpu.model_executor.step_inputs import StepInputs as J

    fields = {k: jnp.asarray(v) for k, v in case.items() if k in J._fields}
    if decode_only:
        for k in ("qt_run", "pre_tile_rows", "pre_runs"):
            fields.pop(k)
    return J(rng=jax.random.PRNGKey(0), **fields)


def assert_common_fields_equal(got, want):
    compared = 0
    for f in PORT_FIELDS:
        if f not in want._fields:
            continue
        g, w = getattr(got, f), getattr(want, f)
        assert (g is None) == (w is None), f
        if g is not None:
            assert np.array_equal(g.numpy(), np.asarray(w)), f
            compared += 1
    return compared


@pytest.mark.parametrize("M", [2, 4])
def test_split_microbatches_equal_jax(M):
    from vattention_tpu.parallel.pipeline import (
        split_microbatches as jax_split)

    case = split_case(B=8, n_pre=0)
    case["sample_idx"] = np.array([0, 1, -1, 3, 4, -1, 6, 7], np.int32)
    got = split_microbatches(port_inputs(case, True), M, 0)
    want = jax_split(jax_inputs(case, True), M, 0)
    assert assert_common_fields_equal(got, want) >= 9


@pytest.mark.parametrize("M", [2, 4])
def test_split_mixed_microbatches_equal_jax(M):
    from vattention_tpu.parallel.pipeline import (
        split_mixed_microbatches as jax_split)

    case = split_case(B=4, n_pre=512)
    case["sample_idx"] = np.array([512 + 0, 130, -1, 512 + 3], np.int32)
    got, m_sel = split_mixed_microbatches(port_inputs(case, False), M, 512,
                                          128)
    want, want_sel = jax_split(jax_inputs(case, False), M, 512, 128)
    assert np.array_equal(m_sel.numpy(), np.asarray(want_sel))
    assert assert_common_fields_equal(got, want) >= 12


@pytest.mark.parametrize("mixed", [False, True])
def test_microbatches_are_aligned(mixed):
    """The kernels take 16-byte aligned tensors: every microbatch's are."""
    from vattention_tpu_torch.parallel.pipeline import microbatch

    if mixed:
        inp = port_inputs(split_case(B=4, n_pre=256), False)
        stacked, _ = split_mixed_microbatches(inp, 2, 256, 128)
    else:
        case = split_case(B=6, n_pre=0)
        case["sample_idx"] = np.arange(6, dtype=np.int32)
        stacked = split_microbatches(port_inputs(case, True), 3, 0)
    for m in range(stacked.token_ids.shape[0]):
        mb = microbatch(stacked, m)
        for f in PORT_FIELDS:
            t = getattr(mb, f)
            if t is not None:
                assert t.data_ptr() % 16 == 0 and t.is_contiguous(), (m, f)
        assert torch.equal(mb.token_ids, stacked.token_ids[m])


def test_microbatch_rule_is_the_jax_runners():
    """M = pp for decode-only steps and for mixed steps whose prefill
    region splits into pp sub-chunks of whole q tiles (not on POD); else
    M = 1.  The prefill region is rounded up to pp q tiles."""
    case = split_case(B=4, n_pre=256)
    stub = types.SimpleNamespace(B=4, pp=2, q_tile=128)
    mixed = port_inputs(case, False)
    assert ModelRunner.microbatches(stub, mixed, 256)[0] == 2
    assert ModelRunner.microbatches(stub, mixed._replace(pod=True), 256)[0] == 1
    stub3 = types.SimpleNamespace(B=4, pp=4, q_tile=128)
    assert ModelRunner.microbatches(stub3, mixed, 256)[0] == 1
    dec = port_inputs(split_case(B=4, n_pre=0), True)
    assert ModelRunner.microbatches(stub, dec, 0)[0] == 2
    assert ModelRunner.microbatches(
        types.SimpleNamespace(B=3, pp=2, q_tile=128),
        port_inputs(split_case(B=3, n_pre=0), True), 0)[0] == 1


# --------------------------------------------------------------------- #
# forwards on ranks against the JAX mesh
# --------------------------------------------------------------------- #
R, BT = 1024, 256  # tests/test_parallel.py's context and block tokens
# make_state's second extents reach row (2B - 1) * BT + BT: its arena of
# R + BT rows leaves some of them out (the JAX kernels clamp or drop
# those accesses), so both packages run here on an arena padded with
# zero rows to hold every row the inputs name
ROWS = 2048


def rank_forward(*, device, store, np_params, cache, inputs, tp, pp, M):
    """One rank's decode step on ``test_parallel.make_state``'s inputs:
    the sampling rank's logits and this rank's arena block after it."""
    mesh = ServingMesh(tp, pp, device=device)
    arch = get_model_arch("tiny-llama-debug")
    layout = ShardLayout.of(mesh)
    model = LlamaForCausalLM(arch, dtype=torch.float32, mesh=mesh)
    params = shard_params(params_from_jax(np_params), arch, layout)
    layers = layout.stage_layers(arch.num_layers)
    hk = arch.num_kv_heads // tp
    kv = torch.from_numpy(np.ascontiguousarray(
        cache[layers.start:layers.stop, :,
              mesh.tp_rank * hk:(mesh.tp_rank + 1) * hk]))
    backend = VattnAttentionBackend(block_tokens=BT, max_context_len=R,
                                    arena_rows=ROWS)
    inp = StepInputs(**{k: torch.from_numpy(v) for k, v in inputs.items()})
    if M > 1:
        stacked = split_microbatches(inp, M, 0)
    else:
        stacked = inp._replace(**{k: v[None] for k, v in inputs_items(inp)})
    logits = pipeline_stage_step(model, backend, params, kv, stacked,
                                 n_pre=0, num_micro=M, mesh=mesh)
    return dict(logits=None if logits is None else torch.cat(logits).numpy(),
                kv=kv.numpy(), pp_rank=mesh.pp_rank, tp_rank=mesh.tp_rank)


def inputs_items(inp):
    return [(k, getattr(inp, k)) for k in PORT_FIELDS
            if getattr(inp, k) is not None]


@pytest.fixture(scope="module")
def jax_state():
    import jax

    from vattention_tpu.config import get_model_arch as jax_arch

    from test_parallel import make_state

    from vattention_tpu.model_executor.attention.vattn_backend import (
        VattnAttentionBackend as JaxVattnBackend)

    arch = jax_arch("tiny-llama-debug")
    full, params, cache, inputs, _ = make_state(arch, 4)
    padded = np.zeros(cache.shape[:3] + (ROWS + BT,) + cache.shape[4:],
                      np.float32)
    padded[:, :, :, :cache.shape[3]] = np.asarray(cache)
    backend = JaxVattnBackend(
        block_tokens=BT, num_segments=inputs.dec_seg_row.shape[1],
        max_context_len=R, arena_rows=ROWS, q_tile=128, scratch_row=ROWS)
    kv_ref, ref_logits = full.forward(params, jax.numpy.asarray(padded),
                                      inputs, backend, 0)
    sub_backend = VattnAttentionBackend(block_tokens=BT, max_context_len=R,
                                        arena_rows=ROWS)
    dec_tile_rows = tile_rows_from_segments(
        np.asarray(inputs.dec_seg_row), np.asarray(inputs.dec_seg_cum),
        sub_backend.sub, sub_backend.n_sub)
    port = {k: np.asarray(getattr(inputs, k)) for k in (
        "token_ids", "positions", "append_rows", "dec_seqlens", "sample_idx",
        "temperatures", "top_p", "top_k")}
    port["dec_tile_rows"] = dec_tile_rows.astype(np.int32)
    return dict(arch=arch, params=params, cache=jax.numpy.asarray(padded),
                inputs=inputs, backend=backend,
                np_params=jax.tree.map(np.asarray, params),
                np_cache=padded, port_inputs=port,
                kv_ref=np.asarray(kv_ref), ref_logits=np.asarray(ref_logits))


def test_tp_forward_equals_jax_shard_map(jax_state):
    """tp=2: the logits of two gloo ranks equal the JAX tp=2 ``shard_map``
    forward's (test_parallel.test_tp_matches_single_device's step)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from vattention_tpu.model_executor.models.llama import (
        LlamaForCausalLM as JaxLlama)
    from vattention_tpu.parallel.mesh import make_serving_mesh
    from vattention_tpu.parallel.sharding import (
        kv_cache_spec, llama_param_specs as jax_specs,
        regroup_gate_up_for_tp as jax_gate_up, regroup_qkv_for_tp as jax_qkv)

    s, tp = jax_state, 2
    arch, params = s["arch"], s["params"]
    mesh = make_serving_mesh(tensor_parallel_size=tp)
    params_tp = dict(params)
    params_tp["layers"] = dict(params["layers"])
    params_tp["layers"]["qkv_w"] = jax_qkv(
        params["layers"]["qkv_w"], arch.num_q_heads, arch.num_kv_heads,
        arch.head_dim, tp)
    params_tp["layers"]["gate_up_w"] = jax_gate_up(
        params["layers"]["gate_up_w"], tp)
    model_tp = JaxLlama(arch, dtype=jnp.float32, tp_size=tp, tp_axis="tp")
    step = jax.jit(jax.shard_map(
        lambda p, c, i: model_tp.forward(p, c, i, s["backend"], 0),
        mesh=mesh,
        in_specs=(jax_specs(tp_axis="tp"), kv_cache_spec(tp_axis="tp"),
                  jax.tree.map(lambda _: P(), s["inputs"])),
        out_specs=(kv_cache_spec(tp_axis="tp"), P()), check_vma=False))
    _, jax_logits = step(params_tp, s["cache"], s["inputs"])

    out = run_ranks(rank_forward, tp, dict(
        np_params=s["np_params"], cache=s["np_cache"],
        inputs=s["port_inputs"], tp=tp, pp=1, M=1), device="cpu",
        timeout_s=150)
    assert out[1]["logits"] is None  # tp-rank 1 computes no head
    np.testing.assert_allclose(out[0]["logits"], np.asarray(jax_logits),
                               atol=2e-3, rtol=2e-3)
    np.testing.assert_allclose(out[0]["logits"], s["ref_logits"],
                               atol=2e-3, rtol=2e-3)


def test_pp_pipeline_in_two_microbatches_matches_single_device(jax_state):
    """pp=2, M=2 (test_parallel.test_pp_pipeline_matches_single_device's
    step): logits within 2e-2 with the same argmax, the arena rows below
    the scratch row within 1e-3 of the single-device forward's."""
    s, pp = jax_state, 2
    out = run_ranks(rank_forward, pp, dict(
        np_params=s["np_params"], cache=s["np_cache"],
        inputs=s["port_inputs"], tp=1, pp=pp, M=2), device="cpu",
        timeout_s=150)
    assert out[0]["logits"] is None  # stage 0 computes no head
    got = out[1]["logits"]
    np.testing.assert_allclose(got, s["ref_logits"], atol=2e-2, rtol=1e-2)
    assert (got.argmax(-1) == s["ref_logits"].argmax(-1)).all()
    kv = np.concatenate([out[0]["kv"], out[1]["kv"]])
    np.testing.assert_allclose(kv[:, :, :, :ROWS],
                               s["kv_ref"][:, :, :, :ROWS],
                               atol=1e-3, rtol=1e-3)


# --------------------------------------------------------------------- #
# the engine from one process
# --------------------------------------------------------------------- #
ENGINE_KW = dict(dtype="float32", attention_backend="fa_vattn",
                 scheduler_type="sarathi", max_model_len=512,
                 max_batch_size=4, max_num_seqs=4, chunk_size=128,
                 gpu_memory_utilization=0.9)


def serve_workload(engine, sampling_cls):
    """test_parallel.test_pp_engine_matches_single_engine's workload."""
    rng = np.random.default_rng(3)
    prompts = {f"r{i}": rng.integers(1, 2000, n).tolist()
               for i, n in enumerate([100, 50])}
    for sid, toks in prompts.items():
        engine.add_request(prompt=None, prompt_token_ids=toks,
                           sampling_params=sampling_cls(
                               temperature=0.0, max_tokens=4,
                               ignore_eos=True),
                           seq_id=sid)
    out, steps = {}, 0
    while engine.has_unfinished_requests():
        for o in engine.step():
            if o.finished:
                out[o.seq_id] = o.token_ids
        steps += 1
        assert steps < 300
    engine.cleanup()
    return out


@pytest.fixture(scope="module")
def jax_engine_checkpoint(tmp_path_factory):
    """The JAX engine's tokens on the workload (one device; the JAX tests
    hold its pp and tp runs to the same tokens), and its weights as a
    safetensors checkpoint."""
    import jax

    from vattention_tpu import LLMEngine as JaxLLMEngine
    from vattention_tpu import SamplingParams as JaxSamplingParams
    from vattention_tpu.metrics.metrics_store import MetricsStore as J
    from vattention_tpu_torch.microbenchmarks.checkpoint import (
        write_checkpoint)

    J._instance = None
    engine = JaxLLMEngine.from_engine_args(model="tiny-llama-debug",
                                           **ENGINE_KW)
    np_params = jax.tree.map(np.asarray, engine.worker.model_runner.params)
    tokens = serve_workload(engine, JaxSamplingParams)
    J._instance = None
    path = tmp_path_factory.mktemp("tiny-llama-ckpt")
    model = LlamaForCausalLM(get_model_arch("tiny-llama-debug"),
                             dtype=torch.float32)
    write_checkpoint(model, params_from_jax(np_params), path)
    return tokens, str(path)


@pytest.mark.parametrize("pp,tp", [(1, 1), (2, 1), (1, 2), (2, 2)])
def test_engine_matches_the_jax_engine(jax_engine_checkpoint, pp, tp):
    """``LLMEngine.from_engine_args`` with pp x tp ranks, called from this
    process (it starts the other ranks), gives the JAX engine's greedy
    tokens."""
    from vattention_tpu_torch import LLMEngine, SamplingParams
    from vattention_tpu_torch.metrics.metrics_store import MetricsStore

    expect, path = jax_engine_checkpoint
    MetricsStore._instance = None
    engine = LLMEngine.from_engine_args(
        model=path, load_format="safetensors", device="cpu",
        pipeline_parallel_size=pp, tensor_parallel_size=tp, **ENGINE_KW)
    if pp * tp > 1:
        mesh = engine.mesh
        assert (mesh.pp_size, mesh.tp_size, mesh.backend) == (pp, tp, "gloo")
        assert engine.worker.cache_engine.kv_cache.shape[:3] == (
            2 // pp, 2, 2 // tp)
        if pp > 1:
            assert type(engine).__name__ == "PipelineParallelLLMEngine"
            assert engine.worker.model_runner.n_pre_fixed % (pp * 128) == 0
    assert serve_workload(engine, SamplingParams) == expect
    MetricsStore._instance = None


# --------------------------------------------------------------------- #
# the memory profile agrees across ranks
# --------------------------------------------------------------------- #
def rank_profile(*, device, store, free_by_rank):
    """This rank's profile when its device reports ``free_by_rank[rank]``
    free bytes."""
    import torch.distributed as dist

    from vattention_tpu_torch.engine.arg_utils import EngineArgs
    from vattention_tpu_torch.worker import base_worker

    rank = dist.get_rank()
    free = free_by_rank[rank]
    base_worker.device_memory = lambda _device: (free, 1 << 34, 0)
    config = EngineArgs(model="tiny-llama-debug", dtype="float32",
                        max_model_len=512, max_batch_size=64,
                        tensor_parallel_size=2,
                        gpu_memory_utilization=1.0,
                        device="cpu").create_engine_configs()
    mesh = ServingMesh(2, 1, device=device)
    worker = base_worker.BaseWorker(config, device, mesh=mesh)
    return worker.profile_num_available_blocks(1.0)


def test_block_count_is_the_minimum_over_ranks():
    """Co-located ranks see different free memory; the profile ends with
    the minimum of the block count and the arena bytes over the ranks."""
    from vattention_tpu_torch.engine.arg_utils import EngineArgs
    from vattention_tpu_torch.worker import base_worker

    free = [200 * 2**20, 120 * 2**20]
    out = run_ranks(rank_profile, 2, dict(free_by_rank=free),
                    device="cpu", timeout_s=120)
    assert out[0] == out[1]
    config = EngineArgs(model="tiny-llama-debug", dtype="float32",
                        max_model_len=512, max_batch_size=64,
                        tensor_parallel_size=2, gpu_memory_utilization=1.0,
                        device="cpu").create_engine_configs()
    alone = []
    saved = base_worker.device_memory
    try:
        for f in free:
            base_worker.device_memory = lambda _d, f=f: (f, 1 << 34, 0)
            alone.append(base_worker.BaseWorker(
                config, torch.device("cpu")).profile_num_available_blocks(
                    1.0))
    finally:
        base_worker.device_memory = saved
    assert alone[0] != alone[1]
    assert tuple(out[0]) == min(alone)
