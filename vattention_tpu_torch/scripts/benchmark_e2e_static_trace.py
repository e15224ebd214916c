"""Static-trace E2E benchmark script on the port.

Twin of ``scripts/benchmark_e2e_static_trace.py:22-83``: the same flags
and defaults, plus ``--device``, and the same loop over model x backend x
context x P:D (ref grid: 50 equal-length requests, metric = makespan).
Each cell decodes ``max(1, ctx // (pd + 1))`` tokens after ``ctx -
decode`` prompt tokens, with ``--max-model-len ctx + 128``, through the
port's ``benchmark.main.add_args`` / ``run_from_args`` (which free the
engine between cells), and gives one JSON row: model, backend, ctx,
pd_ratio, makespan_s, tokens_per_s, preemptions.  ``--test`` runs only
the first cell, shrunk to the tiny model.

Usage:
  python -m vattention_tpu_torch.scripts.benchmark_e2e_static_trace \\
      --test --device cpu
  python -m vattention_tpu_torch.scripts.benchmark_e2e_static_trace \\
      --models yi-6b-200k --backends fa_vattn_2mb fa_paged_256 \\
      --contexts 32768 65536 --pd-ratios 100
"""

from __future__ import annotations

import argparse
import json
import os
from typing import List, Tuple

from vattention_tpu_torch.scripts.common import add_device_arg, resolve


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--test", action="store_true")
    p.add_argument("--models", nargs="+", default=["yi-6b-200k"])
    p.add_argument("--backends", nargs="+",
                   default=["fa_vattn_2mb", "fa_paged_256"])
    p.add_argument("--contexts", nargs="+", type=int, default=[32768])
    p.add_argument("--pd-ratios", nargs="+", type=int,
                   default=[100])  # prefill:decode (ref 500/100/50)
    p.add_argument("--num-requests", type=int, default=50)
    p.add_argument("--max-batch-size", type=int, default=16)
    p.add_argument("--chunk-size", type=int, default=2048)
    p.add_argument("--output", default="benchmark_output/e2e_static.json")
    return add_device_arg(p)


def cells(args) -> List[Tuple[dict, List[str]]]:
    """(row keys, ``benchmark.main`` argv) of every cell in the JAX
    script's order; ``--test`` keeps the first."""
    out = []
    for model in args.models:
        for backend in args.backends:
            for ctx in args.contexts:
                for pd in args.pd_ratios:
                    decode = max(1, ctx // (pd + 1))
                    prefill = ctx - decode
                    argv = [
                        "--model", model,
                        "--attention-backend", backend,
                        "--interval-generator", "static",
                        "--length-generator", "fixed",
                        "--num-requests", str(args.num_requests),
                        "--prefill-tokens", str(prefill),
                        "--decode-tokens", str(decode),
                        "--max-model-len", str(ctx + 128),
                        "--max-batch-size", str(args.max_batch_size),
                        "--max-num-seqs", str(args.max_batch_size),
                        "--chunk-size", str(args.chunk_size),
                    ]
                    if args.test:
                        argv += ["--test"]
                    argv += ["--device", args.device]
                    out.append((dict(model=model, backend=backend, ctx=ctx,
                                     pd_ratio=pd), argv))
    return out[:1] if args.test else out


def main(argv=None) -> list:
    args = parser().parse_args(argv)
    resolve(args.device)
    from vattention_tpu_torch.benchmark.main import add_args, run_from_args

    results = []
    for keys, cell_argv in cells(args):
        bench_args = add_args(argparse.ArgumentParser()).parse_args(cell_argv)
        summary = run_from_args(bench_args)
        results.append(dict(
            keys, makespan_s=summary["totals"]["makespan_s"],
            tokens_per_s=summary["totals"]["tokens_per_s"],
            preemptions=summary["totals"]["preemptions"]))
        print(json.dumps(results[-1]))
    os.makedirs(os.path.dirname(args.output) or ".", exist_ok=True)
    with open(args.output, "w") as f:
        json.dump(results, f, indent=2)
    print(f"wrote {args.output}")
    return results


if __name__ == "__main__":
    main()
