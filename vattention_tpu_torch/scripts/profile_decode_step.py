"""Device against host time in the steady decode step.

Twin of ``scripts/profile_decode_step.py:21-111``: the same flags and defaults,
plus ``--device``.  It builds bench.py's engine (zero weights, sarathi
chunk 512, batch ``--batch``), prefills ``--batch`` prompts of ``--ctx``
tokens, takes 3 decode steps to settle, then:

- (A) times ``--steps`` whole ``engine.step()`` calls: scheduler, input
  staging and the dispatch of the captured step, between CUDA events, the
  span ending when the device has run them;
- (B) replays the decode step's CUDA graph ``--steps`` times on its staged
  inputs (``microbenchmarks/captured_step.next_step`` takes them from the
  engine's own next step; no second capture), between CUDA events: the
  device's time per step.  The arena rows and token buffer the replays
  write are put back after.  On the CPU steps are not captured and (B)
  runs the eager ``ModelRunner._step`` on those inputs;
- (C) times the host's ``_prepare_inputs`` alone, 10 calls.

A - B is host time the asynchronous engine does not hide.

Usage:
  python -m vattention_tpu_torch.scripts.profile_decode_step \\
      [--model yi-6b-200k] [--backend fa_vattn_256kb] [--batch 24]
"""

from __future__ import annotations

import argparse
import time

import torch

from vattention_tpu_torch.scripts.common import Clock, add_device_arg, resolve


def prefill(engine, batch: int, ctx: int) -> None:
    from vattention_tpu_torch import SamplingParams

    for i in range(batch):
        engine.add_request(
            prompt=None,
            prompt_token_ids=[(7 * i + j) % 1000 + 1 for j in range(ctx)],
            sampling_params=SamplingParams(temperature=0.0,
                                           max_tokens=100_000,
                                           ignore_eos=True),
            seq_id=f"b{i}")
    while True:
        engine.step()
        sched = engine.scheduler
        if all(s.prompt_processing_finished for s in sched.running) \
                and not sched.waiting:
            break


def replay_seconds(runner, step: dict, steps: int, clock: Clock) -> float:
    """Seconds per replay of ``step``'s graph (per eager ``_step`` without
    one), the arena rows and token buffer it writes put back after."""
    inputs, n_pre, mode = step["inputs"], step["n_pre"], step["mode"]
    kv = runner.cache_engine.kv_cache
    rows = inputs.append_rows[inputs.append_rows >= 0].long()
    before, tok0 = kv[:, :, :, rows].clone(), runner._tok_buf.clone()
    graph = step["graph"]

    def once():
        if graph is not None:
            runner.replay(graph)
        else:
            runner._step(inputs, n_pre, mode)

    once()
    t0 = clock.mark()
    for _ in range(steps):
        once()
    per = clock.seconds(t0, clock.mark()) / steps
    kv[:, :, :, rows] = before
    runner._tok_buf.copy_(tok0)
    return per


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model", default="yi-6b-200k")
    p.add_argument("--backend", default="fa_vattn_256kb")
    p.add_argument("--batch", type=int, default=24)
    p.add_argument("--ctx", type=int, default=1024)
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--max-model-len", type=int, default=2048)
    return add_device_arg(p)


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    resolve(args.device)
    from vattention_tpu_torch import LLMEngine
    from vattention_tpu_torch.metrics.metrics_store import MetricsStore
    from vattention_tpu_torch.microbenchmarks.captured_step import next_step

    MetricsStore._instance = None
    engine = LLMEngine.from_engine_args(
        model=args.model, load_format="zero",
        attention_backend=args.backend, scheduler_type="sarathi",
        chunk_size=512, max_model_len=args.max_model_len,
        max_batch_size=args.batch, max_num_seqs=args.batch,
        gpu_memory_utilization=0.9, device=args.device)
    try:
        clock = Clock(engine.device)
        runner = engine.worker.model_runner
        prefill(engine, args.batch, args.ctx)
        for _ in range(3):
            engine.step()

        # A) the whole engine loop
        t0 = clock.mark()
        for _ in range(args.steps):
            engine.step()
        a = clock.seconds(t0, clock.mark()) / args.steps

        # B) the decode step's graph on its staged inputs
        step = next_step(engine)
        if step["n_pre"] != 0:
            raise RuntimeError("expected a decode-only steady state, got a "
                               f"prefill region of {step['n_pre']}")
        if engine.device.type == "cuda":
            torch.cuda.synchronize(engine.device)
            if step["graph"] is None:
                raise RuntimeError("the decode step ran without a graph")
        b = replay_seconds(runner, step, args.steps, clock)

        # C) the host's input staging alone
        t0 = time.perf_counter()
        for _ in range(10):
            runner._prepare_inputs(step["metas"])
        c = (time.perf_counter() - t0) / 10
    finally:
        engine.cleanup()
        MetricsStore._instance = None
    what = ("captured device step" if step["graph"] is not None
            else "eager step (no graph)")
    print(f"engine.step():        {a*1e3:8.2f} ms/step "
          f"({args.batch/a:8.1f} tok/s)")
    print(f"{what}: {b*1e3:8.2f} ms/step ({args.batch/b:8.1f} tok/s)")
    print(f"prepare_inputs(host): {c*1e3:8.2f} ms")
    print(f"host overhead not hidden: {(a-b)*1e3:8.2f} ms/step")
    return dict(engine_step_s=a, device_step_s=b, prepare_s=c,
                graph=step["graph"] is not None)


if __name__ == "__main__":
    main()
