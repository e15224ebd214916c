"""Benchmark entry point (ref: sarathi-lean/sarathi/benchmark/main.py).

Counterpart of ``vattention_tpu/benchmark/main.py``, with the same flags
and these differences: ``--device`` picks the engine's device (``cuda``,
the default, or ``cpu``; without a GPU the engine raises unless given
``--device cpu``), and ``--test`` only shrinks the run to a smoke run
(ref scripts/utils.py:8, benchmark_e2e_static_trace.py:20-22) where the
JAX package's also switches to the CPU.  Without ``--max-model-len``
the lengths drawn are clamped to the model's own context (the JAX
package's ``run_from_args`` raises there).  ``--enable-profiling`` traces
the run with torch.profiler.  Flags that name a key of ``default.yml``
(``--section_key``) or ``--config_file`` take the YAML-config path.

Examples:
  python -m vattention_tpu_torch.benchmark.main --test --device cpu
  python -m vattention_tpu_torch.benchmark.main \
      --model yi-6b-200k --attention-backend fa_vattn_2mb \
      --request-generator-provider synthetic \
      --interval-generator static --length-generator fixed \
      --num-requests 50 --prefill-tokens 32768 --decode-tokens 64
"""

from __future__ import annotations

import argparse
import json


def add_args(p: argparse.ArgumentParser):
    p.add_argument("--test", action="store_true",
                   help="tiny smoke run (the tiny debug model)")
    p.add_argument("--device", default="cuda",
                   help="the engine's device: cuda or cpu")
    # engine
    p.add_argument("--model", default="yi-6b-200k")
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--load-format", default="zero")
    p.add_argument("--attention-backend", default="fa_vattn_2mb")
    p.add_argument("--scheduler-type", default="sarathi")
    p.add_argument("--chunk-size", type=int, default=512)
    p.add_argument("--max-model-len", type=int, default=None)
    p.add_argument("--max-batch-size", type=int, default=32)
    p.add_argument("--max-num-seqs", type=int, default=32)
    p.add_argument("--gpu-memory-utilization", type=float, default=0.9)
    p.add_argument("--kv-quant", default="none",
                   help="KV cache dtype: none | fp8 | int8")
    p.add_argument("--enable-dynamic-chunking-schedule", action="store_true")
    p.add_argument("--low-chunk-size", type=int, default=None)
    p.add_argument("--high-chunk-size", type=int, default=None)
    p.add_argument("--chunk-schedule-max-tokens", type=int, default=None)
    p.add_argument("--chunk-schedule-stages", type=int, default=None)
    # workload
    p.add_argument("--request-generator-provider", default="synthetic")
    p.add_argument("--interval-generator", default="static")
    p.add_argument("--length-generator", default="fixed")
    p.add_argument("--num-requests", type=int, default=8)
    p.add_argument("--prefill-tokens", type=int, default=1024)
    p.add_argument("--decode-tokens", type=int, default=64)
    p.add_argument("--min-tokens", type=int, default=128)
    p.add_argument("--max-tokens", type=int, default=4096)
    p.add_argument("--qps", type=float, default=1.0)
    p.add_argument("--cv", type=float, default=0.5)
    p.add_argument("--zipf-theta", type=float, default=0.6)
    p.add_argument("--trace-file", default=None)
    p.add_argument("--prefill-scale-factor", type=float, default=1.0)
    p.add_argument("--decode-scale-factor", type=float, default=1.0)
    p.add_argument("--time-limit", type=float, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--num-replicas", type=int, default=1,
                   help="serving replicas; requests round-robin across "
                        "them and metrics stores are merged (ref "
                        "benchmark_runner.py:201-348)")
    # metrics
    p.add_argument("--output-dir", default="benchmark_output")
    p.add_argument("--enable-chrome-trace", action="store_true")
    p.add_argument("--enable-plots", action="store_true",
                   help="write per-metric cdf+hist PNGs next to the CSVs")
    p.add_argument("--enable-profiling", action="store_true",
                   help="torch.profiler trace around the run "
                        "(ref torch.profiler sessions)")
    p.add_argument("--profiler-dir", default="profiler_output")
    p.add_argument("--no-warmup", action="store_true")
    return p


def _reset_metrics() -> None:
    from vattention_tpu_torch.metrics.metrics_store import MetricsStore

    MetricsStore._instance = None


def _max_model_len(args) -> int:
    """``--max-model-len``, else the model's own context, which the engine
    takes when the flag is left out."""
    if args.max_model_len is not None:
        return args.max_model_len
    from vattention_tpu_torch.config import ModelConfig

    return ModelConfig(model=args.model, dtype=args.dtype).max_model_len


def configs_from_args(args) -> tuple:
    """(engine kwargs, generator config) for ``args``, shrunk by
    ``--test``."""
    if args.test:
        args.model = "tiny-llama-debug"
        args.num_requests = 2
        args.prefill_tokens = min(args.prefill_tokens, 256)
        args.decode_tokens = min(args.decode_tokens, 8)
        args.min_tokens = min(args.min_tokens, 128)
        args.max_tokens = min(args.max_tokens, 512)
        args.prefill_scale_factor = min(args.prefill_scale_factor,
                                        256 / 16384)
        args.decode_scale_factor = min(args.decode_scale_factor, 0.05)
        args.max_model_len = 2048
        args.max_batch_size = 4
        args.max_num_seqs = 4
        args.chunk_size = 128

    engine_kwargs = dict(
        model=args.model, dtype=args.dtype, load_format=args.load_format,
        attention_backend=args.attention_backend,
        scheduler_type=args.scheduler_type, chunk_size=args.chunk_size,
        max_model_len=args.max_model_len, kv_quant=args.kv_quant,
        max_batch_size=args.max_batch_size, max_num_seqs=args.max_num_seqs,
        gpu_memory_utilization=args.gpu_memory_utilization,
        enable_dynamic_chunking_schedule=(
            args.enable_dynamic_chunking_schedule),
        low_chunk_size=args.low_chunk_size,
        high_chunk_size=args.high_chunk_size,
        chunk_schedule_max_tokens=args.chunk_schedule_max_tokens,
        chunk_schedule_stages=args.chunk_schedule_stages,
        write_metrics=True, output_dir=args.output_dir,
        enable_chrome_trace=args.enable_chrome_trace,
        enable_plots=args.enable_plots,
        device=args.device,
    )
    generator_config = dict(
        num_requests=args.num_requests,
        prefill_tokens=args.prefill_tokens,
        decode_tokens=args.decode_tokens,
        min_tokens=args.min_tokens,
        # generated/replayed lengths must fit the engine's context window
        # (traces are clamped, ref trace_request_length_generator.py)
        max_tokens=min(args.max_tokens, _max_model_len(args)),
        qps=args.qps, cv=args.cv, theta=args.zipf_theta,
        trace_file=args.trace_file,
        prefill_scale_factor=args.prefill_scale_factor,
        decode_scale_factor=args.decode_scale_factor,
        interval_generator=args.interval_generator,
        length_generator=args.length_generator,
        seed=args.seed,
    )
    return engine_kwargs, generator_config


def run_from_args(args) -> dict:
    from vattention_tpu_torch.benchmark.benchmark_runner import (
        BenchmarkRunner, BenchmarkRunnerLauncher)

    engine_kwargs, generator_config = configs_from_args(args)
    if args.num_replicas > 1:
        launcher = BenchmarkRunnerLauncher(
            engine_kwargs, args.request_generator_provider,
            generator_config, num_replicas=args.num_replicas,
            time_limit_s=args.time_limit, warmup=not args.no_warmup)
        try:
            summary = launcher.run()
        finally:
            for r in launcher.runners:
                r.engine.cleanup()
            _reset_metrics()
        print(json.dumps(summary["totals"], indent=2))
        return summary
    runner = BenchmarkRunner(
        engine_kwargs, args.request_generator_provider, generator_config,
        time_limit_s=args.time_limit, warmup=not args.no_warmup,
        enable_profiling=args.enable_profiling,
        profiler_dir=args.profiler_dir)
    try:
        summary = runner.run()
    finally:
        # free the weights, graphs and arena before a grid script builds
        # the next engine
        runner.engine.cleanup()
        _reset_metrics()
    print(json.dumps(summary["totals"], indent=2))
    return summary


def run_from_flat(flat: dict) -> dict:
    """YAML-config path (ref main.py + config.ConfigParser): nested
    default.yml flattened into --section_key flags."""
    from vattention_tpu_torch.benchmark.benchmark_runner import (
        BenchmarkRunnerLauncher)
    from vattention_tpu_torch.benchmark.config import flat_to_runner_args

    engine_kwargs, provider, generator_config, opts = \
        flat_to_runner_args(flat)
    if opts["test"]:
        engine_kwargs.update(model="tiny-llama-debug", max_model_len=2048,
                             max_batch_size=4, max_num_seqs=4,
                             chunk_size=128)
        generator_config.update(num_requests=2)
        generator_config["prefill_tokens"] = min(
            generator_config.get("prefill_tokens", 256), 256)
        generator_config["decode_tokens"] = min(
            generator_config.get("decode_tokens", 8), 8)
    launcher = BenchmarkRunnerLauncher(
        engine_kwargs, provider, generator_config,
        num_replicas=opts["num_replicas"],
        time_limit_s=opts["time_limit_s"])
    try:
        summary = launcher.run()
    finally:
        for r in launcher.runners:
            r.engine.cleanup()
        _reset_metrics()
    print(json.dumps(summary["totals"], indent=2))
    return summary


def main():
    import sys

    from vattention_tpu_torch.benchmark.config import ConfigParser

    cp = ConfigParser()
    yaml_flags = ({f"--{k}" for k in cp.defaults} | {"--config_file"})
    argv = sys.argv[1:]
    if any(a.split("=")[0] in yaml_flags for a in argv):
        run_from_flat(cp.parse_args(argv))
    else:
        run_from_args(add_args(argparse.ArgumentParser()).parse_args(argv))


if __name__ == "__main__":
    main()
