"""Configuration objects (ref: sarathi-lean/sarathi/config.py).

The PyTorch port's own copy of ``vattention_tpu/config.py``: the same
dataclasses and architecture registry, so schedules and arena geometry
match the JAX package field for field, defaults included
(``SystemConfig.enable_async_execution`` is True in both).

Differences from the sarathi reference:
  - dtype defaults to bfloat16 instead of fp16.
  - Model descriptions can come from a built-in architecture registry
    (zero-egress environments) or from a local HF ``config.json``.
"""

from __future__ import annotations

import enum
import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

KB = 1024
MB = 1024 * KB
GB = 1024 * MB


class SchedulerType(enum.Enum):
    """ref: sarathi-lean/sarathi/config.py:14-19"""

    VLLM = "vllm"
    ORCA = "orca"
    FASTER_TRANSFORMER = "faster_transformer"
    SARATHI = "sarathi"
    SIMPLE_CHUNKING = "simple_chunking"


@dataclass
class ModelArch:
    """Minimal architecture description needed by the serving engine."""

    model_type: str  # "llama" | "yi" | "mistral" | "qwen" | "internlm" | "falcon" | "opt"
    num_layers: int
    num_q_heads: int
    num_kv_heads: int
    head_dim: int
    hidden_size: int
    intermediate_size: int
    vocab_size: int
    max_position_embeddings: int
    rope_theta: float = 10000.0
    rope_scaling: Optional[Dict[str, Any]] = None
    rms_norm_eps: float = 1e-5
    tie_word_embeddings: bool = False
    qkv_bias: bool = False  # qwen/internlm style
    # falcon-style parallel attn + single ln
    parallel_attn: bool = False
    sliding_window: Optional[int] = None

    @property
    def q_dim(self) -> int:
        return self.num_q_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim


# Built-in architectures so zero-egress benchmarking works without HF hub.
# Dims match the public HF configs of the models used by the reference
# benchmark grid (scripts/utils.py:27-32) plus small test models.
_ARCH_REGISTRY: Dict[str, ModelArch] = {
    # head_dim 128 so tiny configs exercise the TPU-native tile shapes
    "tiny-llama-debug": ModelArch(
        "llama", num_layers=2, num_q_heads=4, num_kv_heads=2, head_dim=128,
        hidden_size=256, intermediate_size=688, vocab_size=2048,
        max_position_embeddings=8192),
    # tiny-llama-debug with mistral's sliding window, cut to 96 positions
    # so that short prompts reach past it (the port's chip_smoke)
    "tiny-mistral-debug": ModelArch(
        "mistral", num_layers=2, num_q_heads=4, num_kv_heads=2, head_dim=128,
        hidden_size=256, intermediate_size=688, vocab_size=2048,
        max_position_embeddings=8192, sliding_window=96),
    # head_dim 64: exercises the arena's 128-lane head padding path
    # (the opt-125m / falcon-7b geometry)
    "tiny-d64-debug": ModelArch(
        "llama", num_layers=2, num_q_heads=4, num_kv_heads=4, head_dim=64,
        hidden_size=256, intermediate_size=688, vocab_size=2048,
        max_position_embeddings=8192),
    "opt-125m": ModelArch(
        "llama", num_layers=12, num_q_heads=12, num_kv_heads=12, head_dim=64,
        hidden_size=768, intermediate_size=3072, vocab_size=50272,
        max_position_embeddings=2048),
    "llama-2-7b": ModelArch(
        "llama", num_layers=32, num_q_heads=32, num_kv_heads=32, head_dim=128,
        hidden_size=4096, intermediate_size=11008, vocab_size=32000,
        max_position_embeddings=4096),
    "llama-3-8b": ModelArch(
        "llama", num_layers=32, num_q_heads=32, num_kv_heads=8, head_dim=128,
        hidden_size=4096, intermediate_size=14336, vocab_size=128256,
        max_position_embeddings=8192, rope_theta=500000.0),
    "llama-3-70b": ModelArch(
        "llama", num_layers=80, num_q_heads=64, num_kv_heads=8, head_dim=128,
        hidden_size=8192, intermediate_size=28672, vocab_size=128256,
        max_position_embeddings=8192, rope_theta=500000.0),
    "yi-6b-200k": ModelArch(
        "yi", num_layers=32, num_q_heads=32, num_kv_heads=4, head_dim=128,
        hidden_size=4096, intermediate_size=11008, vocab_size=64000,
        max_position_embeddings=200000, rope_theta=5000000.0),
    # per-layer geometry of Yi-6B-200k at half depth: the 16GiB v5e
    # cannot hold full Yi-6B bf16 weights (11.3GiB) AND a 128K-context
    # KV slab (4GiB fp8) the way the reference's 80GB A100s can
    # (scripts/utils.py:27-32); halving layers keeps every kernel shape
    # (hidden/heads/head_dim/vocab) real while the long-context A/B fits
    "yi-6b-200k-l16": ModelArch(
        "yi", num_layers=16, num_q_heads=32, num_kv_heads=4, head_dim=128,
        hidden_size=4096, intermediate_size=11008, vocab_size=64000,
        max_position_embeddings=200000, rope_theta=5000000.0),
    "yi-34b-200k": ModelArch(
        "yi", num_layers=60, num_q_heads=56, num_kv_heads=8, head_dim=128,
        hidden_size=7168, intermediate_size=20480, vocab_size=64000,
        max_position_embeddings=200000, rope_theta=5000000.0),
    # Second long-context grid geometries (VERDICT r4 #4: show the
    # contiguous-arena win is not shape-tuned to Yi's GQA-8:1).  Mistral
    # per-layer geometry (GQA 4:1, 8 kv heads -> 2x the KV bytes/token
    # of Yi) at 8 layers so 32K x B8 KV (8.6GiB bf16) + weights fit the
    # 16GiB chip; sliding window disabled so attention depth is real.
    "mistral-7b-32k-l8": ModelArch(
        "mistral", num_layers=8, num_q_heads=32, num_kv_heads=8,
        head_dim=128, hidden_size=4096, intermediate_size=14336,
        vocab_size=32000, max_position_embeddings=200000,
        rope_theta=1000000.0, sliding_window=None),
    # Falcon per-layer geometry (MQA, 1 kv head, head_dim 64 -> the
    # arena's 128-lane head-padding path) at 8 layers, long-rope.
    "falcon-7b-32k-l8": ModelArch(
        "falcon", num_layers=8, num_q_heads=71, num_kv_heads=1,
        head_dim=64, hidden_size=4544, intermediate_size=4 * 4544,
        vocab_size=65024, max_position_embeddings=200000,
        rope_theta=1000000.0, parallel_attn=True),
    "mistral-7b": ModelArch(
        "mistral", num_layers=32, num_q_heads=32, num_kv_heads=8, head_dim=128,
        hidden_size=4096, intermediate_size=14336, vocab_size=32000,
        max_position_embeddings=32768, sliding_window=4096),
    "qwen-14b": ModelArch(
        "qwen", num_layers=40, num_q_heads=40, num_kv_heads=40, head_dim=128,
        hidden_size=5120, intermediate_size=13696, vocab_size=152064,
        max_position_embeddings=8192, qkv_bias=True),
    "internlm-20b": ModelArch(
        "internlm", num_layers=60, num_q_heads=40, num_kv_heads=40, head_dim=128,
        hidden_size=5120, intermediate_size=13824, vocab_size=103168,
        max_position_embeddings=4096, qkv_bias=True),
    "falcon-7b": ModelArch(
        "falcon", num_layers=32, num_q_heads=71, num_kv_heads=1, head_dim=64,
        hidden_size=4544, intermediate_size=4 * 4544, vocab_size=65024,
        max_position_embeddings=2048, parallel_attn=True),
}

# Aliases matching the HF repo names the reference scripts use
# (ref: scripts/utils.py:27-32).
_ARCH_ALIASES = {
    "meta-llama/Meta-Llama-3-8B": "llama-3-8b",
    "meta-llama/Meta-Llama-3-70B": "llama-3-70b",
    "meta-llama/Llama-2-7b-hf": "llama-2-7b",
    "01-ai/Yi-6B-200k": "yi-6b-200k",
    "01-ai/Yi-34B-200k": "yi-34b-200k",
    "mistralai/Mistral-7B-v0.1": "mistral-7b",
    "Qwen/Qwen-14B": "qwen-14b",
    "internlm/internlm-20b": "internlm-20b",
    "tiiuae/falcon-7b": "falcon-7b",
    "facebook/opt-125m": "opt-125m",
}


def _arch_from_hf_config(cfg: Dict[str, Any]) -> ModelArch:
    model_type = cfg.get("model_type", "llama")
    n_heads = cfg["num_attention_heads"]
    hidden = cfg["hidden_size"]
    head_dim = cfg.get("head_dim") or hidden // n_heads
    return ModelArch(
        model_type=model_type,
        num_layers=cfg.get("num_hidden_layers", cfg.get("n_layer")),
        num_q_heads=n_heads,
        num_kv_heads=cfg.get("num_key_value_heads", n_heads),
        head_dim=head_dim,
        hidden_size=hidden,
        intermediate_size=cfg.get("intermediate_size", 4 * hidden),
        vocab_size=cfg["vocab_size"],
        max_position_embeddings=cfg.get("max_position_embeddings", 8192),
        rope_theta=cfg.get("rope_theta", 10000.0),
        rope_scaling=cfg.get("rope_scaling"),
        rms_norm_eps=cfg.get("rms_norm_eps", 1e-5),
        tie_word_embeddings=cfg.get("tie_word_embeddings", False),
        qkv_bias=cfg.get("attention_bias", False) or model_type in ("qwen", "internlm"),
        parallel_attn=cfg.get("parallel_attn", model_type == "falcon"),
        sliding_window=cfg.get("sliding_window"),
    )


def get_model_arch(model: str) -> ModelArch:
    """Resolve a model name/path to a ModelArch.

    Resolution order: local dir with config.json > builtin registry > alias.
    """
    cfg_path = os.path.join(model, "config.json")
    if os.path.isdir(model) and os.path.exists(cfg_path):
        with open(cfg_path) as f:
            return _arch_from_hf_config(json.load(f))
    name = _ARCH_ALIASES.get(model, model)
    if name in _ARCH_REGISTRY:
        return _ARCH_REGISTRY[name]
    raise ValueError(
        f"Unknown model {model!r}. Known: {sorted(_ARCH_REGISTRY)} "
        f"(or pass a local directory containing config.json)")


@dataclass
class ModelConfig:
    """ref: sarathi-lean/sarathi/config.py:22-185"""

    model: str = "tiny-llama-debug"
    dtype: str = "bfloat16"  # "bfloat16" | "float32"
    seed: int = 0
    # Weight loading: "dummy" (random, benchmark default like the reference's
    # load_format dummy), "safetensors" (local dir)
    load_format: str = "dummy"
    max_model_len: Optional[int] = None
    # override rope scaling to stretch context (ref: config.py:502-552)
    rope_scaling: Optional[Dict[str, Any]] = None
    attention_backend: str = "fa_vattn"
    # top-N alternative logprobs computed per sampled token (OpenAI
    # `logprobs`/`top_logprobs`); the sampled token's own logprob is
    # always returned.  0 keeps the [B,V] top_k out of the serving step.
    max_logprobs: int = 0
    arch: ModelArch = field(default=None)  # type: ignore[assignment]

    def __post_init__(self):
        if self.arch is None:
            self.arch = get_model_arch(self.model)
        if self.rope_scaling is not None:
            self.arch.rope_scaling = self.rope_scaling
            factor = float(self.rope_scaling.get("factor", 1.0))
            self.arch.max_position_embeddings = int(
                self.arch.max_position_embeddings * factor)
        if self.max_model_len is None:
            self.max_model_len = self.arch.max_position_embeddings
        assert self.dtype in ("bfloat16", "float32"), self.dtype

    @property
    def dtype_bytes(self) -> int:
        return {"bfloat16": 2, "float32": 4}[self.dtype]

    def get_num_kv_heads(self, parallel_config: "ParallelConfig") -> int:
        """KV heads per TP shard (ref: config.py:139-167)."""
        return max(1, self.arch.num_kv_heads // parallel_config.tensor_parallel_size)

    def get_num_q_heads(self, parallel_config: "ParallelConfig") -> int:
        return max(1, self.arch.num_q_heads // parallel_config.tensor_parallel_size)

    def get_head_size(self) -> int:
        return self.arch.head_dim

    def get_num_layers(self, parallel_config: "ParallelConfig") -> int:
        return self.arch.num_layers // parallel_config.pipeline_parallel_size

    def get_total_num_layers(self) -> int:
        return self.arch.num_layers


@dataclass
class CacheConfig:
    """ref: sarathi-lean/sarathi/config.py:188-220

    ``block_size`` is the scheduler-side accounting granularity in tokens
    (== tokens per KV block).  ``page_size`` is the physical commit
    granularity in bytes for the vattn arena (64KB..2MB equivalents).
    """

    block_size: int = 256
    page_size: int = 2 * MB
    memory_utilization: float = 0.9  # fraction of HBM given to KV cache
    max_batch_size: int = 64
    # Filled in after profiling:
    num_gpu_blocks: Optional[int] = None
    memory_for_gpu: Optional[int] = None
    # Megacache: pack all layers' K+V for a token span into one page group
    megacache: bool = False
    # FP8/INT8 KV quantization ("none" | "fp8" | "int8")
    kv_quant: str = "none"
    # the allocator's core: None (the default) and True take the native
    # C++ core (memory/native.py, built at first use), False the Python one
    use_native_allocator: Optional[bool] = None


@dataclass
class ParallelConfig:
    """ref: sarathi-lean/sarathi/config.py:223-251 — here a JAX mesh spec."""

    pipeline_parallel_size: int = 1
    tensor_parallel_size: int = 1
    data_parallel_size: int = 1  # serving replicas
    # sequence-parallel activations along tp axis inside jit (GSPMD)
    enable_sequence_parallel: bool = False
    expert_parallel_size: int = 1  # reserved for MoE models

    @property
    def world_size(self) -> int:
        return (self.pipeline_parallel_size * self.tensor_parallel_size *
                self.data_parallel_size)


# q-tile granularity of the compiled step's prefill region (ModelRunner
# pads each prefill run to this).  Chunked schedulers charge prefills
# against the token budget at THIS granularity so the padded runs always
# fit one fixed-width region (one jit signature for every mixed step).
# VATTN_Q_TILE is the single source for both (the scheduler's charge
# unit MUST equal the runner's pad unit, or padded runs can overflow
# the fixed region).
PREFILL_TOKEN_PAD = int(os.environ.get("VATTN_Q_TILE", "128"))


@dataclass
class BaseSchedulerConfig:
    """ref: sarathi-lean/sarathi/config.py:254-391"""

    max_num_seqs: int = 64
    max_model_len: int = 8192
    num_pipeline_stages: int = 1
    # prefill RUNS admitted per iteration (the step packs up to this many
    # padded prompt chunks into one prefill-attention launch; lifts the
    # reference sarathi one-prefill-per-batch default and lets the vLLM
    # scheduler batch whole prompts like the reference's, sarathi-lean
    # vllm_scheduler.py:20+).  The POD backends take the same limit:
    # kernel F fuses every prefill run of a mixed step with its decodes.
    max_prefills_per_step: int = 4

    @property
    def type(self) -> SchedulerType:
        raise NotImplementedError

    def get_max_num_batched_tokens(self, max_model_len: int) -> int:
        raise NotImplementedError


@dataclass
class VllmSchedulerConfig(BaseSchedulerConfig):
    max_batched_tokens: Optional[int] = None

    @property
    def type(self) -> SchedulerType:
        return SchedulerType.VLLM

    def get_max_num_batched_tokens(self, max_model_len: int) -> int:
        if self.max_batched_tokens:
            return min(self.max_batched_tokens, max_model_len)
        return max_model_len


@dataclass
class SarathiSchedulerConfig(BaseSchedulerConfig):
    chunk_size: int = 512
    # multiple partial prefills may share one step's chunk budget (the
    # reference carries the same flag, sarathi_scheduler.py:41; here it
    # defaults on because the TPU step fuses K runs into one launch)
    enable_rolling_prefills: bool = True
    enable_dynamic_chunking_schedule: bool = False
    low_chunk_size: Optional[int] = None
    high_chunk_size: Optional[int] = None
    chunk_schedule_max_tokens: Optional[int] = None
    chunk_schedule_stages: Optional[int] = None

    @property
    def type(self) -> SchedulerType:
        return SchedulerType.SARATHI

    def get_max_num_batched_tokens(self, max_model_len: int) -> int:
        return self.chunk_size


@dataclass
class SimpleChunkingSchedulerConfig(BaseSchedulerConfig):
    chunk_size: int = 512

    @property
    def type(self) -> SchedulerType:
        return SchedulerType.SIMPLE_CHUNKING

    def get_max_num_batched_tokens(self, max_model_len: int) -> int:
        return self.chunk_size


@dataclass
class OrcaSchedulerConfig(BaseSchedulerConfig):
    @property
    def type(self) -> SchedulerType:
        return SchedulerType.ORCA

    def get_max_num_batched_tokens(self, max_model_len: int) -> int:
        return self.max_num_seqs * max_model_len


@dataclass
class FasterTransformerSchedulerConfig(BaseSchedulerConfig):
    @property
    def type(self) -> SchedulerType:
        return SchedulerType.FASTER_TRANSFORMER

    def get_max_num_batched_tokens(self, max_model_len: int) -> int:
        return self.max_num_seqs * max_model_len


@dataclass
class MetricsConfig:
    """ref: sarathi-lean/sarathi/config.py:394-443"""

    write_metrics: bool = True
    output_dir: str = "benchmark_output"
    enable_op_level_metrics: bool = False
    enable_chrome_trace: bool = False
    # per-metric cdf + histogram PNGs next to the CSVs (ref
    # metrics_store.py:243-264 plotly layer; matplotlib here)
    enable_plots: bool = False
    enable_request_outputs: bool = False
    keep_individual_batch_metrics: bool = False
    wandb_project: Optional[str] = None
    wandb_group: Optional[str] = None
    wandb_run_name: Optional[str] = None


@dataclass
class SystemConfig:
    """Bundle of all configs handed to engine/workers."""

    model_config: ModelConfig = field(default_factory=ModelConfig)
    cache_config: CacheConfig = field(default_factory=CacheConfig)
    parallel_config: ParallelConfig = field(default_factory=ParallelConfig)
    scheduler_config: BaseSchedulerConfig = field(
        default_factory=SarathiSchedulerConfig)
    metrics_config: MetricsConfig = field(default_factory=MetricsConfig)
    # async execution: dispatch steps without waiting for their sampled
    # tokens (device-side token feedback, host bookkeeping up to
    # max_inflight_steps steps behind)
    enable_async_execution: bool = True
    max_inflight_steps: int = 2
    # where the engine runs: "cuda" (the default) or "cpu", which only the
    # tests ask for (the kernels' plain PyTorch versions run there)
    device: str = "cuda"
