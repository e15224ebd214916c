"""Pipeline parallelism's per-step cost: pp = 1 against pp = 2.

Twin of ``scripts/measure_pp_step.py:41-85``: the same engine
(tiny-llama-debug, zero weights, fa_vattn, sarathi chunk 256, batch 4,
max_model_len 2048), the same 4 seeded prompts of 1500 - 300 i tokens and
64 greedy tokens each (a sustained run of mixed prefill + decode steps), 6
steps to warm, then the median of 24 timed steps, at
``pipeline_parallel_size`` 1 and 2.  The
JAX script runs pp = 2 as virtual devices of one controller; here pp = 2
is the port's ranks (``LLMEngine`` starts the second stage as a child
process, ``parallel/multihost``): gloo over the CPU with ``--device cpu``,
or two ranks sharing the card (gloo stages each transfer through host
memory, and every step runs eagerly).  A step is timed from its dispatch
to a device synchronization, on the driving rank.  The GPipe bubble
arithmetic of the JAX script is printed beside: with M = pp microbatches
per step, pp chips give at most pp * M / (M + pp - 1) times one chip's
throughput, 2 * 2 / 3 = 1.33 for pp = 2.

Usage:
  python -m vattention_tpu_torch.scripts.measure_pp_step [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from vattention_tpu_torch.scripts.common import add_device_arg, resolve


def run(pp: int, device: str, steps: int = 24) -> float:
    """Median seconds of a mixed step at ``pipeline_parallel_size`` pp."""
    from vattention_tpu_torch import LLMEngine, SamplingParams
    from vattention_tpu_torch.metrics.metrics_store import MetricsStore

    MetricsStore._instance = None
    engine = LLMEngine.from_engine_args(
        model="tiny-llama-debug", load_format="zero",
        attention_backend="fa_vattn", scheduler_type="sarathi",
        chunk_size=256, max_model_len=2048,
        max_batch_size=4, max_num_seqs=4,
        pipeline_parallel_size=pp,
        gpu_memory_utilization=0.9, device=device)
    dev = torch.device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    try:
        rng = np.random.default_rng(3)
        # long prompts + early decoders -> a sustained run of mixed steps
        for i in range(4):
            engine.add_request(
                prompt=None,
                prompt_token_ids=rng.integers(1, 2000, 1500 - 300 * i
                                              ).tolist(),
                sampling_params=SamplingParams(
                    temperature=0.0, max_tokens=64, ignore_eos=True),
                seq_id=f"p{i}")
        # warm both serving signatures
        for _ in range(6):
            engine.step()
        times = []
        for _ in range(steps):
            sync()
            t0 = time.perf_counter()
            engine.step()
            sync()
            times.append(time.perf_counter() - t0)
    finally:
        engine.cleanup()
        MetricsStore._instance = None
    times.sort()
    return times[len(times) // 2]


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    return add_device_arg(p)


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    resolve(args.device)
    t1 = run(1, args.device)
    t2 = run(2, args.device)
    print(f"median mixed-step time  pp=1: {t1 * 1e3:8.1f} ms")
    print(f"median mixed-step time  pp=2: {t2 * 1e3:8.1f} ms")
    print(f"pp=2 machinery overhead vs pp=1 ({args.device}, ranks as "
          f"processes): {t2 / t1:5.2f}x")
    print("ideal 2-chip speedup from GPipe bubble math (M=pp=2): "
          "2*2/(2+1) = 1.33x per-step throughput")
    return {"pp1_s": t1, "pp2_s": t2}


if __name__ == "__main__":
    main()
