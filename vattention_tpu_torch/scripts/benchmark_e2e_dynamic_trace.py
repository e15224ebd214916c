"""Dynamic-trace E2E benchmark script on the port.

Twin of ``scripts/benchmark_e2e_dynamic_trace.py:23-97``: the same flags and
defaults, plus ``--device`` and ``--sweep``, and the same loop over backend
x QPS (ref: Poisson arrivals, arxiv-summarization-style lengths, metric =
request e2e time normalized by output length, p50/p90/p99).  Each cell
runs through the port's ``benchmark.main.add_args`` / ``run_from_args``;
``--trace-file`` replays a CSV's lengths (``num_prefill_tokens``,
``num_decode_tokens``, e.g. ``data/processed_traces/arxiv_synthetic_v2.csv``),
else lengths are uniform in ``[--min-tokens, --max-tokens]``.  The output is
self-describing: ``{"meta": <the arguments>, "results": [...]}``.

``--sweep`` takes ``scripts/run_dynamic_sweep.sh``'s settings in place of
the flags': yi-6b-200k-l16, fa_vattn_2mb / fa_paged_256 / fa_pod, QPS 0.8,
2 and 6, 32 requests of 2048-8192 tokens, max_model_len 16384, batch 16,
chunk 512.

Usage:
  python -m vattention_tpu_torch.scripts.benchmark_e2e_dynamic_trace \\
      --test --device cpu
  python -m vattention_tpu_torch.scripts.benchmark_e2e_dynamic_trace --sweep
"""

from __future__ import annotations

import argparse
import json
import os
from typing import List, Tuple

from vattention_tpu_torch.scripts.common import add_device_arg, resolve

# scripts/run_dynamic_sweep.sh's invocation
SWEEP = dict(model="yi-6b-200k-l16",
             backends=["fa_vattn_2mb", "fa_paged_256", "fa_pod"],
             qps=[0.8, 2.0, 6.0], num_requests=32, min_tokens=2048,
             max_tokens=8192, max_model_len=16384, max_batch_size=16,
             chunk_size=512)


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--test", action="store_true")
    p.add_argument("--sweep", action="store_true",
                   help="run_dynamic_sweep.sh's settings")
    p.add_argument("--model", default="llama-3-8b")
    p.add_argument("--backends", nargs="+",
                   default=["fa_vattn_2mb", "fa_paged_256"])
    p.add_argument("--qps", nargs="+", type=float,
                   default=[0.4, 0.8, 1.0, 2.0, 4.0, 6.0])
    p.add_argument("--num-requests", type=int, default=256)
    p.add_argument("--trace-file", default=None,
                   help="CSV with num_prefill_tokens,num_decode_tokens")
    p.add_argument("--max-model-len", type=int, default=32768)
    p.add_argument("--min-tokens", type=int, default=4096)
    p.add_argument("--max-tokens", type=int, default=16384)
    p.add_argument("--max-batch-size", type=int, default=32)
    p.add_argument("--chunk-size", type=int, default=512)
    p.add_argument("--time-limit", type=float, default=None)
    p.add_argument("--output", default="benchmark_output/e2e_dynamic.json")
    return add_device_arg(p)


def parse(argv=None) -> argparse.Namespace:
    args = parser().parse_args(argv)
    if args.sweep:
        for k, v in SWEEP.items():
            setattr(args, k, v)
    return args


def cells(args) -> List[Tuple[dict, List[str]]]:
    """(row keys, ``benchmark.main`` argv) of every cell in the JAX
    script's order; ``--test`` keeps the first."""
    out = []
    for backend in args.backends:
        for qps in args.qps:
            argv = [
                "--model", args.model,
                "--attention-backend", backend,
                "--interval-generator", "poisson",
                "--qps", str(qps),
                "--num-requests", str(args.num_requests),
                "--max-model-len", str(args.max_model_len),
                "--max-batch-size", str(args.max_batch_size),
                "--max-num-seqs", str(args.max_batch_size),
                "--chunk-size", str(args.chunk_size),
            ]
            if args.trace_file:
                argv += ["--length-generator", "trace",
                         "--trace-file", args.trace_file]
            else:
                # arxiv-summarization-like lengths without the file
                argv += ["--length-generator", "uniform",
                         "--min-tokens", str(args.min_tokens),
                         "--max-tokens", str(args.max_tokens)]
            if args.time_limit:
                argv += ["--time-limit", str(args.time_limit)]
            if args.test:
                argv += ["--test"]
            argv += ["--device", args.device]
            out.append((dict(model=args.model, backend=backend, qps=qps),
                        argv))
    return out[:1] if args.test else out


def main(argv=None) -> dict:
    args = parse(argv)
    resolve(args.device)
    from vattention_tpu_torch.benchmark.main import add_args, run_from_args

    results = []
    for keys, cell_argv in cells(args):
        bench_args = add_args(argparse.ArgumentParser()).parse_args(cell_argv)
        summary = run_from_args(bench_args)
        norm = summary["request_e2e_time_normalized"]
        results.append(dict(
            keys,
            normalized_e2e_p50=norm["p50"],
            normalized_e2e_p90=norm["p90"],
            normalized_e2e_p99=norm["p99"],
            scheduling_delay_p50=summary["scheduling_delay"]["p50"],
            scheduling_delay_p99=summary["scheduling_delay"]["p99"],
            ttft_p50=summary["ttft"]["p50"],
            ttft_p90=summary["ttft"]["p90"],
            tokens_per_s=summary["totals"]["tokens_per_s"]))
        print(json.dumps(results[-1]))
    os.makedirs(os.path.dirname(args.output) or ".", exist_ok=True)
    out = {"meta": vars(args), "results": results}
    with open(args.output, "w") as f:
        json.dump(out, f, indent=2)
    print(f"wrote {args.output}")
    return out


if __name__ == "__main__":
    main()
