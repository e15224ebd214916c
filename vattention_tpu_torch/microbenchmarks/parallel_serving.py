"""Serving throughput of one engine laid out as tp x pp ranks, checked.

    python3 -m vattention_tpu_torch.microbenchmarks.parallel_serving \\
        --layouts one,tp2,pp2,tp4,tp2pp2 --passes 2

Each layout's ranks are processes (``parallel.multihost.run_ranks``), one
per GPU when the host has a GPU for every rank (nccl: each step signature
a CUDA graph, collectives included), else sharing the cards over gloo
(collectives staged through host memory, steps eager).  The one-rank
layout always runs first.  In each layout's processes:

- the check: tiny-llama-debug in float32 on fa_vattn, fa_paged_256 and
  fa_pod (layouts of at most its 2 kv heads over tp), 2 seeded requests
  of 6 greedy tokens.  Every rank's tokens must equal the one-rank
  layout's exactly, the backend must be ``mesh.pick_backend``'s, and every
  rank must have captured its steps in CUDA graphs under nccl and none
  under gloo.  A float32 model leaves bf16 drift no room to hide a wrong
  collective or a wrong capture of one;
- the measurement: chip_smoke (c)'s requests (``requests``: 8 seeded
  prompts of 1024-4096 tokens and 32 greedy tokens each) through
  ``serve_multihost`` on yi-6b-200k at full width (bf16, dummy weights
  from seed 0, fa_vattn_2mb, sarathi chunk 512, batch 8, max_model_len
  8192), ``passes`` times, each on a fresh engine (the first pass also
  pays each process's first loads and its collectives' set-up).  Request
  s0's first token is held, in every pass of every layout, within
  ``LOGIT_GAP_TOL`` logits of the top of a dense float32 forward of the
  same weights (``dense_logits``).

Per layout and pass it prints a JSON line: the backend, the graphs
captured, the serving wall (host clock around the pass, ending in a device
synchronization), processed (prompt + generated) tokens per second, how
many generated tokens equal the one-rank layout's, and s0's logit gap.  A
failed check raises, so the exit code is non-zero.  ``--device cpu`` runs
it on the CPU at tiny-llama-debug's size (gloo).
"""

from __future__ import annotations

import argparse
import json
import subprocess
from typing import Dict, List, Tuple

import numpy as np
import torch

# layout name -> (pp, tp)
LAYOUTS: Dict[str, Tuple[int, int]] = {
    "one": (1, 1), "tp2": (1, 2), "pp2": (2, 1), "tp4": (1, 4),
    "tp2pp2": (2, 2)}
ENGINE_ARGS = dict(model="yi-6b-200k", dtype="bfloat16",
                   attention_backend="fa_vattn_2mb", scheduler_type="sarathi",
                   chunk_size=512, max_model_len=8192, max_batch_size=8,
                   max_num_seqs=8, seed=0)
# the check's model: float32, 2 kv heads (so tp <= 2)
CHECK_ARGS = dict(model="tiny-llama-debug", dtype="float32",
                  scheduler_type="sarathi", chunk_size=128, max_model_len=512,
                  max_batch_size=4, max_num_seqs=4, seed=0)
CHECK_BACKENDS = ("fa_vattn", "fa_paged_256", "fa_pod")
CHECK_MAX_TP = 2
LOGIT_GAP_TOL = 0.25  # s0's first token's logit vs the dense reference's top


def requests(vocab: int = 64000, lo: int = 1024, hi: int = 4096,
             n: int = 8, max_tokens: int = 32) -> List[dict]:
    """chip_smoke (c)'s requests as ``add_request`` keywords."""
    from vattention_tpu_torch import SamplingParams

    rng = np.random.default_rng(0)
    lens = rng.integers(lo, hi + 1, n)
    return [dict(prompt=None,
                 prompt_token_ids=rng.integers(1, vocab, int(m)).tolist(),
                 sampling_params=SamplingParams(
                     temperature=0.0, max_tokens=max_tokens,
                     ignore_eos=True),
                 seq_id=f"s{i}")
            for i, m in enumerate(lens)]


def serve_runs(pp: int, tp: int, runs: List[Tuple[dict, List[dict]]], *,
               device: str = "cuda", memory_utilization: float = 0.9,
               timeout_s: float = 600) -> List[List[dict]]:
    """Serve each run's (engine_args, requests), one after the other, on
    fresh engines of pp x tp ranks in the same processes; each rank's
    ``serve_requests`` results, in rank order.  Ranks that share a device
    split ``memory_utilization`` between them."""
    from vattention_tpu_torch.parallel.mesh import ranks_per_device
    from vattention_tpu_torch.parallel.multihost import (run_ranks,
                                                         serve_requests)

    world = pp * tp
    share = ranks_per_device(world, device) if device == "cuda" else 1
    payload = [dict(engine_args=dict(args, pipeline_parallel_size=pp,
                                     tensor_parallel_size=tp,
                                     gpu_memory_utilization=(
                                         memory_utilization / share)),
                    requests=reqs) for args, reqs in runs]
    return run_ranks(serve_requests, world, dict(runs=payload),
                     device=device, timeout_s=timeout_s)


def serve_layout(pp: int, tp: int, engine_args: dict, reqs: List[dict], *,
                 passes: int = 1, device: str = "cuda",
                 memory_utilization: float = 0.9,
                 timeout_s: float = 600) -> List[List[dict]]:
    """Serve ``reqs`` ``passes`` times on one engine of pp x tp ranks."""
    return serve_runs(pp, tp, [(engine_args, reqs)] * passes, device=device,
                      memory_utilization=memory_utilization,
                      timeout_s=timeout_s)


def check_layout(name: str, world: int, ranks: List[List[dict]],
                 base: List[dict], device: str) -> dict:
    """Hold each rank's check runs (one per ``CHECK_BACKENDS``) to the
    one-rank layout's ``base`` tokens, and its backend and graphs to the
    layout's rule; raises on any mismatch."""
    from vattention_tpu_torch.parallel.mesh import (pick_backend,
                                                    ranks_per_device)

    backend = pick_backend(device, ranks_per_device(world, device))
    for i, attn in enumerate(CHECK_BACKENDS):
        for res in (r[i] for r in ranks):
            if res["outputs"] != base[i]["outputs"]:
                raise AssertionError(
                    f"({name}) {attn} rank {res['coords']}: "
                    f"{res['outputs']} != one rank's {base[i]['outputs']}")
            if world == 1:
                continue
            if res["backend"] != backend:
                raise AssertionError(f"({name}) backend {res['backend']}, "
                                     f"the rule gives {backend}")
            if (res["graphs"] > 0) != (backend == "nccl"):
                raise AssertionError(
                    f"({name}) {attn} rank {res['coords']}: "
                    f"{res['graphs']} graphs under {backend}")
    return dict(check="float32 tokens", layout=name, model="tiny-llama-debug",
                backends=list(CHECK_BACKENDS),
                backend=ranks[0][0]["backend"],
                graphs=[r[0]["graphs"] for r in ranks],
                tokens_equal_to_one=True)


def dense_logits(engine_args: dict, ids: List[int],
                 device: torch.device) -> torch.Tensor:
    """Last-position logits of ``ids`` through a full-recompute forward of
    the engine's llama model on its dummy weights (drawn from the engine's
    seed as the engine draws them), in float32 arithmetic."""
    from vattention_tpu_torch.config import get_model_arch
    from vattention_tpu_torch.model_executor.layers.activation import (
        silu_and_mul)
    from vattention_tpu_torch.model_executor.layers.layernorm import rms_norm
    from vattention_tpu_torch.model_executor.models import get_model_class

    arch = get_model_arch(engine_args["model"])
    if arch.parallel_attn or arch.sliding_window:
        raise ValueError("the dense reference is llama's, unwindowed")
    model = get_model_class(arch.model_type)(
        arch, dtype=getattr(torch, engine_args["dtype"]))
    params = model.init_params(device, seed=engine_args["seed"])
    lp, D, T = params["layers"], model.head_dim, len(ids)
    group = model.hq // model.hkv
    positions = torch.arange(T, device=device)
    x = params["embed"][torch.tensor(ids, device=device)].float()
    for l in range(arch.num_layers):
        h = rms_norm(x, lp["input_norm"][l].float(), arch.rms_norm_eps)
        q, k, v = (h @ lp["qkv_w"][l].float()).split(
            [model.hq * D, model.hkv * D, model.hkv * D], -1)
        q, k = model.rope(positions, q.reshape(T, model.hq, D),
                          k.reshape(T, model.hkv, D))
        v = v.reshape(T, model.hkv, D)
        attn = torch.nn.functional.scaled_dot_product_attention(
            q.transpose(0, 1), k.repeat_interleave(group, 1).transpose(0, 1),
            v.repeat_interleave(group, 1).transpose(0, 1), is_causal=True,
            scale=model.sm_scale)
        x = x + attn.transpose(0, 1).reshape(T, -1) @ lp["o_w"][l].float()
        h = rms_norm(x, lp["post_norm"][l].float(), arch.rms_norm_eps)
        x = x + silu_and_mul(h @ lp["gate_up_w"][l].float()) \
            @ lp["down_w"][l].float()
    x = rms_norm(x, params["final_norm"].float(), arch.rms_norm_eps)
    return x[-1] @ params["lm_head"].float()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layouts", default=",".join(LAYOUTS))
    ap.add_argument("--passes", type=int, default=2)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    engine_args = dict(ENGINE_ARGS)
    if args.device == "cpu":
        # the tiny model's size: f32, short prompts
        engine_args.update(model="tiny-llama-debug", dtype="float32",
                           attention_backend="fa_vattn", chunk_size=128,
                           max_model_len=512, max_batch_size=4,
                           max_num_seqs=4)
        reqs = requests(vocab=2000, lo=40, hi=200, n=2, max_tokens=4)
        ref_device = torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device (pass --device cpu)")
        reqs = requests()
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()
        print(f"{torch.cuda.device_count()} x {card[0]}", flush=True)
        ref_device = torch.device("cuda", 0)
    check_runs = [(dict(CHECK_ARGS, attention_backend=b),
                   requests(vocab=2000, lo=40, hi=200, n=2, max_tokens=6))
                  for b in CHECK_BACKENDS]
    layouts = ["one"] + [n for n in args.layouts.split(",") if n != "one"]
    processed = (sum(len(r["prompt_token_ids"]) for r in reqs)
                 + sum(r["sampling_params"].max_tokens for r in reqs))
    base = check_base = None
    served = {}
    for name in layouts:
        pp, tp = LAYOUTS[name]
        checked = check_runs if tp <= CHECK_MAX_TP else []
        out = serve_runs(pp, tp, checked + [(engine_args, reqs)] * args.passes,
                         device=args.device)
        if checked:
            if name == "one":
                check_base = out[0][:len(checked)]
            print(json.dumps(check_layout(name, pp * tp,
                                          [o[:len(checked)] for o in out],
                                          check_base, args.device)),
                  flush=True)
        served[name] = []
        for i in range(len(checked), len(checked) + args.passes):
            ranks = [o[i] for o in out]
            tokens = ranks[0]["outputs"]
            if any(r["outputs"] != tokens for r in ranks):
                raise AssertionError(f"{name}: the ranks' tokens differ")
            if base is None:
                base = tokens
            served[name].append(dict(
                layout=name, pp=pp, tp=tp, pass_=i - len(checked),
                backend=ranks[0]["backend"],
                graphs=[r["graphs"] for r in ranks],
                wall_s=ranks[0]["wall"],
                processed_tok_s=processed / ranks[0]["wall"],
                tokens_equal_to_one=sum(a == b for s in tokens
                                        for a, b in zip(tokens[s], base[s])),
                generated=sum(len(v) for v in tokens.values()),
                s0_first_token=tokens["s0"][0]))
    logits = dense_logits(engine_args, reqs[0]["prompt_token_ids"],
                          ref_device)
    top = int(logits.argmax())
    failed = []
    for name, lines in served.items():
        for line in lines:
            gap = float(logits.max() - logits[line["s0_first_token"]])
            line.update(s0_dense_top=top, s0_logit_gap=gap,
                        logit_gap_tol=LOGIT_GAP_TOL)
            print(json.dumps(line), flush=True)
            if not gap <= LOGIT_GAP_TOL:
                failed.append((name, line["pass_"], gap))
    if failed:
        raise AssertionError(f"s0's first token past {LOGIT_GAP_TOL} logits "
                             f"of the dense reference's top: {failed}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
