"""Where a full-width engine's serving time goes on the card, and the same
profiled windows of two checkouts in turns.

    python3 -m vattention_tpu_torch.microbenchmarks.serving_profile \\
        --trees build/parent build/change --rounds 5 --out build/serving_profile

``profile_window`` runs requests under ``torch.profiler`` and prints the
lines ``chip_smoke.py`` prints as "(p <tag>)": the wall and the device's
busy share; device time by family (the port's kernels, kernel A among
them under every name it has had and the elementwise kernels of
``ops/norm_act.py`` since they exist, matmuls, the rest); each port kernel's
time and launches; per engine step the kernel launches and the host's
``cudaStreamSynchronize`` calls (the profiler's CPU events); and the
device time spent rotating Q and K and appending K/V, whatever runs it
(the eager rope and kernel A, or kernel A alone), with the part of it
that is not kernel A; per engine step the host's launch calls
(``cudaLaunchKernel`` and ``cudaGraphLaunch``) and its milliseconds
outside waits for the device (the profiled wall less the time in
``cudaStreamSynchronize``, ``cudaEventSynchronize`` and
``cudaDeviceSynchronize``, over the steps).

With ``--trees`` each pass runs this file in a process of its own, from
the checkout it profiles and with that checkout first on ``sys.path``:
the file uses only the engine's public API, so it profiles earlier
checkouts too.  A pass serves, after a warm-up request, each ``--case``:
(c) yi-6b-200k on fa_vattn_2mb (sarathi chunk 512, max_model_len 8192,
batch 8; 4 requests of 2048 prompt tokens and 16 greedy tokens), (g)
mistral-7b on fa_vattn_2mb (max_model_len 16384; 2 requests of 6144 +
16) and (k) falcon-7b on fa_vattn_2mb as (c) (its add_layer_norm and
gelu_new), random weights from seed 0, each case's requests once without
the profiler (its wall is "wall unprofiled ms") and then once more under
it; every port kernel's device ms and launches go into the table.  The trees run in turns, reversed every other round
(A B, B A, ...); each pass's output goes to ``<out>/<tree>_<round>.txt``
and a table of every pass's numbers with each tree's mean to
``<out>/summary.json``.  Needs the card.
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

# kernel A: its launcher's names before and after it rotated
A_KERNELS = ("rope_kv_append_kernel", "kv_copy_kernel", "kv_quantize_kernel",
             "kv_append_kernel")
# the layer's elementwise kernels (ops/norm_act.py), which took the norms,
# activations and residual adds out of "other"
NORM_KERNELS = ("add_rms_norm_kernel", "silu_and_mul_kernel",
                "add_layer_norm_kernel", "gelu_new_kernel")
PORT_KERNELS = A_KERNELS + NORM_KERNELS + (
    "prefill_attention", "decode_attention_kernel", "arena_relocate",
    "pod_attention")
MATMUL = ("gemm", "gemv", "xmma", "nvjet", "cutlass", "matmul")
ROPE_APPEND = "rope + KV append"

CASES = {
    "c": dict(model="yi-6b-200k", max_model_len=8192, n=4, prompt=2048),
    "g": dict(model="mistral-7b", max_model_len=16384, n=2, prompt=6144),
    "k": dict(model="falcon-7b", max_model_len=8192, n=4, prompt=2048),
}


def log(*args):
    print(*args, flush=True)


def serve(engine, requests, stats=None):
    """requests: [(seq_id, prompt ids, max_tokens)] -> {seq_id: tokens};
    ``stats["steps"]`` gets the number of engine steps."""
    from vattention_tpu_torch import SamplingParams

    for seq_id, ids, max_tokens in requests:
        engine.add_request(prompt=None, prompt_token_ids=ids,
                           sampling_params=SamplingParams(
                               temperature=0.0, max_tokens=max_tokens,
                               ignore_eos=True),
                           seq_id=seq_id)
    out = {}
    steps = 0
    while engine.has_unfinished_requests():
        for o in engine.step():
            if o.finished:
                out[o.seq_id] = o.token_ids
        steps += 1
        if steps > 10_000:
            raise AssertionError("serving did not finish")
    if stats is not None:
        stats["steps"] = steps
    return out


class _Labelled:
    """Calls ``fn`` inside ``record_function(ROPE_APPEND)``; other
    attributes are ``fn``'s (a rope's ``head_dim``, ``kernel_args``)."""

    def __init__(self, fn):
        self._fn = fn

    def __getattr__(self, name):
        return getattr(self._fn, name)

    def __call__(self, *args, **kwargs):
        with torch.profiler.record_function(ROPE_APPEND):
            return self._fn(*args, **kwargs)


def label_rope_and_append(engine):
    """Put the engine's rope and KV append calls under one profiler label
    (a tree before kernel A rotated: the model's rope and the backend's
    ``append_kv``; after: the backend's ``rope_append_kv``).  Returns a
    function that takes the labels off."""
    runner = engine.worker.model_runner
    model, backend = runner.model, runner.backend
    fused = hasattr(backend, "rope_append_kv")
    undo = []
    for obj, name in ((backend, "rope_append_kv"), (backend, "append_kv"),
                      (model, "rope")):
        if not hasattr(obj, name) or (fused and name == "rope"):
            continue
        orig = getattr(obj, name)
        undo.append((obj, name, name in vars(obj), orig))
        setattr(obj, name, _Labelled(orig))

    def off():
        for obj, name, own, orig in undo:
            if own:
                setattr(obj, name, orig)
            else:
                delattr(obj, name)
    return off


def labelled_device_ms(prof):
    """Device milliseconds of the kernels that ran inside the device-side
    spans of the ``ROPE_APPEND`` label (one stream: a kernel that starts
    inside a span was launched inside the label), or None if the profiler
    recorded no such span."""
    from torch.autograd import DeviceType

    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.name == ROPE_APPEND)
    if not spans:
        return None
    starts = [s for s, _ in spans]
    total = 0.0
    for e in events:
        if e.name == ROPE_APPEND:
            continue
        i = bisect.bisect_right(starts, e.time_range.start) - 1
        if i >= 0 and e.time_range.start < spans[i][1]:
            total += e.time_range.end - e.time_range.start
    return total / 1e3


def profile_window(engine, requests, tag) -> dict:
    """Serve ``requests`` under torch.profiler; print the "(p ``tag``)"
    lines and return their numbers."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    unlabel = label_rope_and_append(engine)
    stats = {}
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            serve(engine, requests, stats)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    finally:
        unlabel()
    steps = stats["steps"]
    events = prof.key_averages()
    # (the label's own span on the device timeline is not a kernel)
    device = [(e.key, e.self_device_time_total / 1e3, e.count)
              for e in events if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0 and e.key != ROPE_APPEND]
    n, prompt = len(requests), len(requests[0][1])
    if not device:
        log(f"(p {tag}) the profiler recorded no device time (wall "
            f"{wall:.1f} ms)")
        return {}
    busy = sum(ms for _, ms, _ in device)
    families = {"port kernels": 0.0, "matmul": 0.0, "other": 0.0}
    port = {}
    for name, ms, count in device:
        if any(s in name for s in PORT_KERNELS):
            families["port kernels"] += ms
            short = re.search(r"(\w+_kernel)", name).group(1)
            ms0, n0 = port.get(short, (0.0, 0))
            port[short] = (ms0 + ms, n0 + count)
        elif any(s in name.lower() for s in MATMUL):
            families["matmul"] += ms
        else:
            families["other"] += ms
    launches = sum(c for name, _, c in device
                   if not name.startswith(("Memcpy", "Memset")))
    cpu = {e.key: e for e in events if e.device_type == DeviceType.CPU}

    def calls(name):
        return cpu[name].count if name in cpu else 0
    syncs = calls("cudaStreamSynchronize")
    api = {k: calls(k) / steps for k in ("cudaLaunchKernel",
                                         "cudaGraphLaunch")}
    waits_ms = sum(cpu[k].cpu_time_total / 1e3 for k in (
        "cudaStreamSynchronize", "cudaEventSynchronize",
        "cudaDeviceSynchronize") if k in cpu)
    host_ms = (wall - waits_ms) / steps
    labelled = labelled_device_ms(prof)
    a_ms = sum(ms for k, (ms, _) in port.items() if k in A_KERNELS)
    log(f"(p {tag}) profiled {n} x ({prompt} + {requests[0][2]}) tokens: "
        f"wall {wall:.1f} ms, device busy {busy:.1f} ms "
        f"({100 * busy / wall:.1f}%), idle {100 - 100 * busy / wall:.1f}%; "
        + ", ".join(f"{k} {v:.1f} ms" for k, v in families.items()))
    log(f"(p {tag}) port kernels: " + ", ".join(
        f"{k} {ms:.2f} ms in {c}" for k, (ms, c) in sorted(
            port.items(), key=lambda kv: -kv[1][0])))
    log(f"(p {tag}) per step ({steps} steps): {launches / steps:.1f} kernel "
        f"launches, host calls " + ", ".join(
            f"{k} {v:.2f}" for k, v in api.items())
        + f", {syncs / steps:.2f} cudaStreamSynchronize, host {host_ms:.3f} "
        f"ms outside waits ({waits_ms:.1f} ms of waits in all); "
        f"{ROPE_APPEND}: "
        + ("not measured (no device span under its label)"
           if labelled is None else
           f"{labelled:.2f} ms of device time, of it outside kernel A "
           f"{labelled - a_ms:.2f} ms"))
    for name, ms, count in sorted(device, key=lambda r: -r[1])[:8]:
        log(f"(p {tag})   {ms:9.2f} ms {count:6d} x {name[:90]}")
    return {"wall ms": wall, "busy ms": busy, "busy share": busy / wall,
            **{f"{k} ms": v for k, v in families.items()},
            "A ms": a_ms, "launches per step": launches / steps,
            **{f"{k} ms": ms for k, (ms, _) in port.items()},
            **{f"{k} launches": n for k, (_, n) in port.items()},
            "syncs per step": syncs / steps,
            **{f"{k} per step": v for k, v in api.items()},
            "host ms per step": host_ms, "steps": steps,
            **({} if labelled is None else {
                f"{ROPE_APPEND} ms": labelled,
                f"{ROPE_APPEND} outside A ms": labelled - a_ms})}


def profile_case(tag: str) -> dict:
    """One full-width engine on fa_vattn_2mb: a warm-up request, then the
    profiled window of CASES[tag]."""
    from vattention_tpu_torch import LLMEngine
    from vattention_tpu_torch.metrics.metrics_store import MetricsStore

    case = CASES[tag]
    MetricsStore._instance = None
    engine = LLMEngine.from_engine_args(
        model=case["model"], dtype="bfloat16",
        attention_backend="fa_vattn_2mb", scheduler_type="sarathi",
        chunk_size=512, max_model_len=case["max_model_len"],
        max_batch_size=8, max_num_seqs=8, seed=0)
    rng = np.random.default_rng(0)
    vocab = engine.worker.model_runner.model.arch.vocab_size

    def reqs(prefix, n):
        return [(f"{prefix}{i}", rng.integers(1, vocab,
                                              case["prompt"]).tolist(), 16)
                for i in range(n)]
    serve(engine, reqs("w", 1))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    serve(engine, reqs("u", case["n"]))
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    log(f"(p {tag}) the same requests without the profiler: wall "
        f"{wall:.1f} ms")
    out = {"wall unprofiled ms": wall,
           **profile_window(engine, reqs("t", case["n"]), tag)}
    engine.cleanup()
    del engine
    torch.cuda.empty_cache()
    return out


def run_trees(trees, rounds: int, out_dir: Path, timeout: float,
              cases=("c", "g")) -> int:
    out_dir.mkdir(parents=True, exist_ok=True)
    # the card's name and power limit, beside every number of the table
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)
    me = Path(__file__).resolve()
    table = {}
    for rnd in range(rounds):
        order = trees if rnd % 2 == 0 else trees[::-1]
        for tree in order:
            label = tree.name
            env = {**os.environ, "PYTHONPATH": str(tree)}
            path = out_dir / f"{label}_{rnd}.txt"
            t0 = time.perf_counter()
            with open(path, "w") as f:
                proc = subprocess.run(
                    [sys.executable, str(me), "--case", *cases, "--json"],
                    cwd=tree, env=env, stdout=f, stderr=subprocess.STDOUT,
                    timeout=timeout)
            text = path.read_text()
            print(f"{label} round {rnd}: rc {proc.returncode}, "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
            if proc.returncode != 0:
                print(text[-4000:])
                return 1
            nums = json.loads(text.strip().splitlines()[-1])
            for key, v in nums.items():
                table.setdefault(key, {}).setdefault(label, []).append(v)
    summary = {key: {label: {"passes": vals, "mean": sum(vals) / len(vals)}
                     for label, vals in per.items()}
               for key, per in table.items()}
    (out_dir / "summary.json").write_text(json.dumps(summary, indent=1))
    for key, per in summary.items():
        print(f"{key}: " + "; ".join(
            f"{label} " + " / ".join(f"{v:.4g}" for v in d["passes"])
            + f" (mean {d['mean']:.4g})" for label, d in per.items()))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--case", nargs="+", choices=sorted(CASES),
                   help="the windows to serve (default: c; c g with "
                        "--trees)")
    p.add_argument("--json", action="store_true",
                   help="print the numbers as one JSON line last")
    p.add_argument("--trees", nargs=2, type=Path,
                   help="two checkouts to profile in turns")
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--out", type=Path, default=Path("build/serving_profile"))
    p.add_argument("--timeout", type=float, default=900.0,
                   help="seconds for one pass")
    args = p.parse_args(argv)
    if args.trees:
        return run_trees([t.resolve() for t in args.trees], args.rounds,
                         args.out, args.timeout, args.case or ("c", "g"))
    if not torch.cuda.is_available():
        print("serving_profile: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    log(f"{torch.cuda.get_device_name(0)}; torch {torch.__version__}")
    nums = {}
    for tag in args.case or ["c"]:
        nums.update({f"(p {tag}) {k}": v
                     for k, v in profile_case(tag).items()})
    if args.json:
        print(json.dumps(nums))
    return 0


if __name__ == "__main__":
    sys.exit(main())
