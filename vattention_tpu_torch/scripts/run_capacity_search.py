"""Capacity search on the card: the highest Poisson QPS whose scheduling
delay meets an SLO.

Twin of ``scripts/run_capacity_search.py:21-82`` over the port's
``CapacitySearch`` (ref sarathi-lean capacity_search.py:72-244): the same
flags and defaults, plus ``--device``, the same engine per backend
(``load_format="zero"``, sarathi chunk 1024, batch 16, memory utilization
0.9) and workload (``--num-requests`` requests of ``--prefill-tokens`` +
``--decode-tokens``; 96 requests against a batch of 16 so that a rate
past capacity builds a backlog), and the same search (0.5 to 8 QPS,
tolerance 0.25, at most 5 bisection steps; each probe at most 600 s).  The
port's search differs in one place, pinned by
``tests/test_torch_benchmark.py::test_capacity_search_bisects_when_the_slo_binds_at_64``:
when the probe at the growth cap of 64 QPS fails, it bisects below 64
where the JAX package returns the last passing rate.  Each backend's
result (capacity, every probe, the SLO, the workload, the search's wall
seconds) is a JSON row of ``--output``.  Probe outputs go to
``benchmark_output/capsearch``.

Usage:
  python -m vattention_tpu_torch.scripts.run_capacity_search \\
      [--model yi-6b-200k-l16] [--backends fa_vattn_2mb] [--slo-s 5]
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import List, Tuple

from vattention_tpu_torch.scripts.common import add_device_arg, resolve

PROBE_DIR = "benchmark_output/capsearch"
SEARCH = dict(qps_low=0.5, qps_high=8.0, tolerance=0.25, max_iters=5)
PROBE_TIME_LIMIT_S = 600.0


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model", default="yi-6b-200k-l16")
    p.add_argument("--backends", nargs="+",
                   default=["fa_vattn_2mb", "fa_paged_256"])
    p.add_argument("--num-requests", type=int, default=96)
    p.add_argument("--slo-s", type=float, default=5.0)
    p.add_argument("--quantile", type=float, default=0.9)
    p.add_argument("--max-model-len", type=int, default=8192)
    p.add_argument("--prefill-tokens", type=int, default=2048)
    p.add_argument("--decode-tokens", type=int, default=128)
    p.add_argument("--output",
                   default="benchmark_output/capacity_search.json")
    return add_device_arg(p)


def configs(args, backend: str) -> Tuple[dict, dict]:
    """(engine kwargs, generator config) of ``backend``'s search."""
    engine_kwargs = dict(
        model=args.model, load_format="zero",
        attention_backend=backend, scheduler_type="sarathi",
        chunk_size=1024, max_model_len=args.max_model_len,
        max_batch_size=16, max_num_seqs=16,
        gpu_memory_utilization=0.9, write_metrics=True,
        output_dir=PROBE_DIR, device=args.device)
    generator_config = dict(
        interval_generator="poisson", length_generator="fixed",
        prefill_tokens=args.prefill_tokens,
        decode_tokens=args.decode_tokens)
    return engine_kwargs, generator_config


def make_search(args, backend: str):
    from vattention_tpu_torch.benchmark.capacity_search.capacity_search \
        import CapacitySearch, SLOConfig

    engine_kwargs, generator_config = configs(args, backend)
    return CapacitySearch(
        engine_kwargs, generator_config,
        SLOConfig(scheduling_delay_slo_s=args.slo_s,
                  scheduling_delay_quantile=args.quantile),
        num_requests=args.num_requests, time_limit_s=PROBE_TIME_LIMIT_S)


def main(argv=None) -> List[dict]:
    args = parser().parse_args(argv)
    resolve(args.device)
    results = []
    for backend in args.backends:
        t0 = time.time()
        search = make_search(args, backend)
        capacity = search.search(**SEARCH)
        results.append({
            "model": args.model, "backend": backend,
            "capacity_qps": capacity,
            "probes": search.probes,
            "slo": {"scheduling_delay_s": args.slo_s,
                    "quantile": args.quantile},
            "workload": {"prefill": args.prefill_tokens,
                         "decode": args.decode_tokens,
                         "num_requests": args.num_requests},
            "search_wall_s": round(time.time() - t0, 1),
        })
        print(json.dumps(results[-1]))
    os.makedirs(os.path.dirname(args.output) or ".", exist_ok=True)
    with open(args.output, "w") as f:
        json.dump(results, f, indent=2)
    print(f"wrote {args.output}")
    return results


if __name__ == "__main__":
    main()
