"""YAML-backed benchmark configuration.

Counterpart of ``vattention_tpu/benchmark/config/config.py``: the nested
YAML (``default.yml``, a copy of the JAX package's) flattens into
``--section_key`` flags, the command line overrides any key, and
``flat_to_runner_args`` maps the flat dict onto the engine's kwargs and
the request generator's config, as in the JAX package.  One key more:
``device`` (``--device``, or a top-level ``device:`` in a YAML file;
default ``cuda``) is the engine's device.  PyYAML is imported only where a
YAML file is read.
"""

from __future__ import annotations

import argparse
import os
from typing import Any, Dict, Optional

_DEFAULT_YML = os.path.join(os.path.dirname(__file__), "default.yml")


def _load_yaml(path: str) -> Dict[str, Any]:
    import yaml

    with open(path) as f:
        return yaml.safe_load(f) or {}


def _flatten(d: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key, value in d.items():
        name = f"{prefix}_{key}" if prefix else key
        if isinstance(value, dict):
            out.update(_flatten(value, name))
        else:
            out[name] = value
    return out


def _typed(default: Any):
    """argparse type callable matching a default's type (None -> str)."""
    if isinstance(default, bool):
        return lambda v: str(v).lower() in ("1", "true", "yes", "on")
    if isinstance(default, int):
        return int
    if isinstance(default, float):
        return float
    return str


class ConfigParser:
    """Flatten default.yml (or a user YAML) into --section_key flags."""

    def __init__(self, config_file: Optional[str] = None):
        self.defaults = _flatten(_load_yaml(config_file or _DEFAULT_YML))

    def parse_args(self, argv=None) -> Dict[str, Any]:
        p = argparse.ArgumentParser(
            description="vattention_tpu_torch benchmark (YAML-config "
                        "driven)")
        p.add_argument("--config_file", default=None,
                       help="YAML overriding the built-in default.yml")
        p.add_argument("--test", action="store_true",
                       help="tiny smoke run (the tiny debug model)")
        p.add_argument("--device", default=None,
                       help="the engine's device: cuda (default) or cpu")
        for key, default in self.defaults.items():
            p.add_argument(f"--{key}", type=_typed(default), default=None)
        args, unknown = p.parse_known_args(argv)
        if unknown:
            raise SystemExit(f"unknown benchmark flags: {unknown}")
        flat = dict(self.defaults)
        if args.config_file:
            flat.update(_flatten(_load_yaml(args.config_file)))
        for key in self.defaults:
            v = getattr(args, key, None)
            if v is not None:
                flat[key] = v
        flat["test"] = args.test
        if args.device is not None:
            flat["device"] = args.device
        flat.setdefault("device", "cuda")
        return flat


def flat_to_runner_args(flat: Dict[str, Any]):
    """flat config -> (engine_kwargs, provider, generator_config, opts)."""
    sched = flat["replica_scheduler_provider"]
    sched_key = {"sarathi": "sarathi_scheduler",
                 "vllm": "vllm_scheduler",
                 "simple_chunking": "simple_chunking_scheduler",
                 "orca": "replica_scheduler",
                 "faster_transformer": "replica_scheduler"}[sched]
    block = int(flat["model_block_size"])
    engine_kwargs = dict(
        model=flat["model_name"],
        dtype=flat["model_dtype"],
        load_format=flat["model_load_format"],
        attention_backend=flat["model_attention_backend"],
        scheduler_type=sched,
        max_model_len=flat["model_max_model_len"],
        max_batch_size=flat["model_max_batch_size"],
        max_num_seqs=flat["replica_scheduler_max_batch_size"],
        gpu_memory_utilization=flat["gpu_memory_utilization"],
        tensor_parallel_size=flat["model_tensor_parallel_degree"],
        pipeline_parallel_size=flat["model_pipeline_parallel_degree"],
        kv_quant=flat["model_kv_quant"],
        seed=flat["seed"],
        write_metrics=flat["write_metrics"],
        output_dir=flat["output_dir"],
        enable_chrome_trace=flat["write_chrome_trace"],
        enable_async_execution=flat["enable_async_execution"],
        device=flat.get("device", "cuda"),
    )
    # block_size in bytes = vattn page size; small ints = paged block tokens
    if block >= 16 * 1024:
        engine_kwargs["page_size"] = block
    else:
        engine_kwargs["block_size"] = block
    if sched_key == "sarathi_scheduler":
        engine_kwargs.update(
            chunk_size=flat["sarathi_scheduler_chunk_size"],
            enable_dynamic_chunking_schedule=flat[
                "sarathi_scheduler_enable_dynamic_chunking_schedule"],
            low_chunk_size=flat["sarathi_scheduler_low_chunk_size"],
            high_chunk_size=flat["sarathi_scheduler_high_chunk_size"],
            chunk_schedule_max_tokens=flat[
                "sarathi_scheduler_chunk_schedule_max_tokens"],
            chunk_schedule_stages=flat[
                "sarathi_scheduler_chunk_schedule_stages"])
    elif sched_key == "simple_chunking_scheduler":
        engine_kwargs.update(
            chunk_size=flat["simple_chunking_scheduler_chunk_size"])
    elif sched_key == "vllm_scheduler":
        engine_kwargs.update(
            max_batched_tokens=flat["vllm_scheduler_max_tokens_in_batch"])

    provider = flat["request_generator_provider"]
    length = flat["synthetic_request_generator_length_provider"]
    interval = flat["synthetic_request_generator_interval_provider"]
    generator_config: Dict[str, Any] = dict(
        num_requests=flat["synthetic_request_generator_num_requests"],
        interval_generator=interval,
        length_generator=length,
        seed=flat["seed"],
    )
    if provider == "trace_replay" or provider == "trace":
        provider = "trace_replay"
        generator_config.update(
            trace_file=flat["trace_request_generator_trace_file"],
            time_scale_factor=flat[
                "trace_request_generator_time_scale_factor"])
    if length == "trace":
        generator_config.update(
            trace_file=flat["trace_request_length_generator_trace_file"],
            prefill_scale_factor=flat[
                "trace_request_length_generator_prefill_scale_factor"],
            decode_scale_factor=flat[
                "trace_request_length_generator_decode_scale_factor"],
            max_tokens=flat["trace_request_length_generator_max_tokens"])
    elif length == "fixed":
        generator_config.update(
            prefill_tokens=flat[
                "fixed_request_length_generator_prefill_tokens"],
            decode_tokens=flat[
                "fixed_request_length_generator_decode_tokens"])
    elif length == "uniform":
        generator_config.update(
            min_tokens=flat["uniform_request_length_generator_min_tokens"],
            max_tokens=flat["uniform_request_length_generator_max_tokens"],
            prefill_to_decode_ratio=flat[
                "uniform_request_length_generator_prefill_to_decode_ratio"])
    elif length == "zipf":
        generator_config.update(
            min_tokens=flat["zipf_request_length_generator_min_tokens"],
            max_tokens=flat["zipf_request_length_generator_max_tokens"],
            theta=flat["zipf_request_length_generator_theta"],
            scramble=flat["zipf_request_length_generator_scramble"],
            prefill_to_decode_ratio=flat[
                "zipf_request_length_generator_prefill_to_decode_ratio"])
    if interval == "poisson":
        generator_config["qps"] = flat[
            "poisson_request_interval_generator_qps"]
    elif interval == "gamma":
        generator_config.update(
            qps=flat["gamma_request_interval_generator_qps"],
            cv=flat["gamma_request_interval_generator_cv"])

    opts = dict(
        num_replicas=flat["cluster_num_replicas"],
        time_limit_s=flat["time_limit"],
        test=flat.get("test", False),
    )
    return engine_kwargs, provider, generator_config, opts
