"""Per-phase step times of two backends brought to the same state: where
a vattn/paged makespan gap sits, in prefill or in decode.

Twin of ``scripts/profile_backend_step.py:23-89``: the same flags and
defaults, plus ``--device``.  ``drive`` builds each backend's engine at the
same geometry (zero weights, sarathi chunk 2048, ``max_model_len`` ctx +
256, batch = ``--batch``, memory utilization 0.95), adds ``--batch``
prompts of ``ctx`` tokens, and steps until every prompt is processed (the
prefill steps, counted and timed as one span), then takes 3 decode steps
to settle and times ``--steps`` steady decode steps.  The port's engine is
asynchronous (a step returns once dispatched, its samples read up to two
steps later), so each span runs between CUDA events on the engine's stream
and ends by waiting for its last event: device time of the work the steps
enqueued, never a host clock around work still running.  On the CPU the
steps run as they are enqueued and the host clock times them.

Usage:
  python -m vattention_tpu_torch.scripts.profile_backend_step \\
      [--ctx 16384] [--batch 4] [--steps 30] [--kv-quant none]
"""

from __future__ import annotations

import argparse
import gc

import torch

from vattention_tpu_torch.scripts.common import Clock, add_device_arg, resolve

CHUNK = 2048


def drive(model, backend, ctx, batch, steps, kv_quant, device="cuda",
          **engine_kw):
    """(prefill seconds, prefill steps, decode seconds per step) of
    ``backend`` serving ``batch`` prompts of ``ctx`` tokens."""
    from vattention_tpu_torch import LLMEngine, SamplingParams
    from vattention_tpu_torch.metrics.metrics_store import MetricsStore

    MetricsStore._instance = None
    engine = LLMEngine.from_engine_args(**dict(dict(
        model=model, load_format="zero", kv_quant=kv_quant,
        attention_backend=backend, scheduler_type="sarathi",
        chunk_size=CHUNK, max_model_len=ctx + 256,
        max_batch_size=batch, max_num_seqs=batch,
        gpu_memory_utilization=0.95, device=device), **engine_kw))
    clock = Clock(engine.device)
    try:
        for i in range(batch):
            engine.add_request(
                prompt=None,
                prompt_token_ids=[(13 * i + j) % 1000 + 1
                                  for j in range(ctx)],
                sampling_params=SamplingParams(
                    temperature=0.0, max_tokens=100_000, ignore_eos=True),
                seq_id=f"p{i}")

        # the prefill phase: every step until the prompts are done
        t0 = clock.mark()
        n_prefill_steps = 0
        while True:
            engine.step()
            n_prefill_steps += 1
            sched = engine.scheduler
            if all(s.prompt_processing_finished for s in sched.running) \
                    and not sched.waiting:
                break
            if n_prefill_steps >= 10_000:
                raise RuntimeError("the prompts were not processed in "
                                   "10,000 steps")
        t_prefill = clock.seconds(t0, clock.mark())

        # settle the decode signature, then the steady decode steps
        for _ in range(3):
            engine.step()
        t0 = clock.mark()
        for _ in range(steps):
            engine.step()
        t_decode = clock.seconds(t0, clock.mark()) / steps
    finally:
        engine.cleanup()
        MetricsStore._instance = None
        gc.collect()
        if engine.device.type == "cuda":
            torch.cuda.empty_cache()
    return t_prefill, n_prefill_steps, t_decode


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model", default="yi-6b-200k-l16")
    p.add_argument("--ctx", type=int, default=16384)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--kv-quant", default="fp8")
    p.add_argument("--backends", nargs="+",
                   default=["fa_vattn_2mb", "fa_paged_256"])
    return add_device_arg(p)


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    resolve(args.device)
    out = {}
    print("backend\tprefill_total_s\tprefill_steps\tdecode_s_per_step")
    for backend in args.backends:
        tp, ns, td = drive(args.model, backend, args.ctx, args.batch,
                           args.steps, args.kv_quant, args.device)
        out[backend] = (tp, ns, td)
        print(f"{backend}\t{tp:.2f}\t{ns}\t{td*1e3:.2f}ms")
    return out


if __name__ == "__main__":
    main()
