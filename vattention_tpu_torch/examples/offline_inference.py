"""Offline inference through the port's LLMEngine directly.

Counterpart of ``examples/offline_inference.py``: add requests, step until
done, print each request's tokens and the throughput.  It serves the tiny
debug model with dummy weights (token-id I/O) by default; pass ``--model
<local-hf-dir> --load-format safetensors`` for a local checkpoint.

    python -m vattention_tpu_torch.examples.offline_inference [--device cpu]

It runs on the GPU unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import time


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model", default="tiny-llama-debug")
    p.add_argument("--load-format", default="dummy")
    p.add_argument("--backend", default="fa_vattn")
    p.add_argument("--scheduler", default="sarathi")
    p.add_argument("--num-requests", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=180)
    p.add_argument("--max-tokens", type=int, default=24)
    p.add_argument("--max-model-len", type=int, default=4096)
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = p.parse_args()

    from vattention_tpu_torch import LLMEngine, SamplingParams

    engine = LLMEngine.from_engine_args(
        model=args.model,
        load_format=args.load_format,
        attention_backend=args.backend,
        scheduler_type=args.scheduler,
        max_model_len=args.max_model_len,
        max_batch_size=8,
        max_num_seqs=8,
        chunk_size=256,
        device=args.device,
    )

    prompts = [[(13 + 7 * i + j) % 1000 + 1 for j in range(args.prompt_len)]
               for i in range(args.num_requests)]
    for i, toks in enumerate(prompts):
        engine.add_request(
            prompt=None, prompt_token_ids=toks,
            sampling_params=SamplingParams(
                temperature=0.0, max_tokens=args.max_tokens,
                ignore_eos=True),
            seq_id=f"req{i}")

    t0 = time.time()
    steps = 0
    done = {}
    while engine.has_unfinished_requests():
        for out in engine.step():
            if out.finished:
                done[out.seq_id] = out
        steps += 1
        if steps > 10000:
            raise RuntimeError("did not converge")
    dt = time.time() - t0

    for seq_id in sorted(done):
        out = done[seq_id]
        print(f"{seq_id}: prompt[:6]={out.prompt_token_ids[:6]} "
              f"-> generated {len(out.token_ids)} tokens: "
              f"{out.token_ids[:10]}... ({out.finish_reason})")
    total_tokens = sum(
        len(o.token_ids) + len(o.prompt_token_ids) for o in done.values())
    print(f"done: {len(done)} requests, {steps} steps, {dt:.1f}s, "
          f"{total_tokens / dt:.0f} tok/s on {engine.device}")
    engine.cleanup()


if __name__ == "__main__":
    main()
