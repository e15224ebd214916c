"""What a ``torch.profiler`` window says: device busy time, kernel families,
idle gaps by what the host was doing, host time outside waits.

The arithmetic is ``vattention_tpu_torch/microbenchmarks/serving_profile.py``'s
(kernel families by name, host ms a step = profiled wall less the time in
CUDA synchronizations, over the steps), copied here, with one change: the
busy time is the union of the device intervals, not the sum of kernel
times, so that it stays right if kernels ever overlap.

The harness marks its own host phases with ``record_function`` labels
(``SPANS``); they name the idle gaps and bound the window.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

WINDOW = "port_bench.window"
STEP = "engine.step"
ADMIT = "port_bench.admit"
WAIT = "port_bench.wait_for_arrival"
SPANS = (WINDOW, STEP, ADMIT, WAIT)

# kernel families (serving_profile's names)
PREFILL_ATTN = ("prefill_attention",)
DECODE_ATTN = ("decode_attention",)
MATMUL = ("gemm", "gemv", "xmma", "nvjet", "cutlass", "matmul",
          "splitkreduce")
PORT = ("rope_kv_append_kernel", "kv_copy_kernel", "kv_quantize_kernel",
        "kv_append_kernel", "add_rms_norm_kernel", "silu_and_mul_kernel",
        "add_layer_norm_kernel", "gelu_new_kernel", "prefill_attention",
        "decode_attention", "arena_relocate", "pod_attention")
SYNCS = ("cudaStreamSynchronize", "cudaEventSynchronize",
         "cudaDeviceSynchronize")


def family(name: str) -> str:
    if any(s in name for s in PREFILL_ATTN):
        return "prefill_attn"
    if any(s in name for s in DECODE_ATTN):
        return "decode_attn"
    if any(s in name for s in PORT):
        return "port_other"
    if any(s in name.lower() for s in MATMUL):
        return "matmul"
    return "other"


@dataclass
class Summary:
    window_s: float                 # the traced window, profiler clock
    busy_s: float                   # union of device intervals in it
    family_s: Dict[str, float]      # device seconds by kernel family
    top_ops: List[Tuple[str, float]]    # device seconds by op name
    idle_gaps: List[Tuple[str, float]]  # idle seconds by host activity
    sync_s: float                   # host seconds in CUDA syncs
    wait_s: float                   # host seconds waiting for arrivals
    steps: int                      # engine.step spans in the window
    device_events: int = 0


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    merged: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1] = (merged[-1][0], e)
        else:
            merged.append((s, e))
    return merged


def _events(prof):
    """(name, is_device, start_ns, end_ns, is_annotation) of every event."""
    from torch.autograd import DeviceType

    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        annotation = getattr(e, "is_user_annotation", None)
        yield (e.name(), e.device_type() != DeviceType.CPU, start,
               start + e.duration_ns(),
               bool(annotation()) if annotation is not None else False)


def summarize(prof, top: int = 10) -> Optional[Summary]:
    """The window's summary, or None when the profiler recorded no
    window."""
    host: List[Tuple[str, int, int]] = []
    dev: List[Tuple[str, int, int]] = []
    for name, on_device, s, e, annotation in _events(prof):
        if on_device:
            if not annotation and name not in SPANS:
                dev.append((name, s, e))
        else:
            host.append((name, s, e))
    win = [(s, e) for n, s, e in host if n == WINDOW]
    if not win:
        return None
    w0, w1 = win[0]
    dev = [(n, max(s, w0), min(e, w1)) for n, s, e in dev
           if e > w0 and s < w1]
    busy = _union([(s, e) for _, s, e in dev])
    busy_ns = sum(e - s for s, e in busy)
    fam: Dict[str, float] = {}
    ops: Dict[str, float] = {}
    for n, s, e in dev:
        fam[family(n)] = fam.get(family(n), 0.0) + (e - s) / 1e9
        ops[n] = ops.get(n, 0.0) + (e - s) / 1e9
    in_win = [(n, s, e) for n, s, e in host if s >= w0 and e <= w1]
    sync_s = sum(e - s for n, s, e in in_win if n in SYNCS) / 1e9
    wait_s = sum(e - s for n, s, e in in_win if n == WAIT) / 1e9
    steps = sum(1 for n, _, _ in in_win if n == STEP)
    return Summary(
        window_s=(w1 - w0) / 1e9, busy_s=busy_ns / 1e9, family_s=fam,
        top_ops=sorted(ops.items(), key=lambda kv: -kv[1])[:top],
        idle_gaps=_idle_by_host(busy, w0, w1, in_win)[:top],
        sync_s=sync_s, wait_s=wait_s, steps=steps, device_events=len(dev))


def _idle_by_host(busy, w0: int, w1: int, host) -> List[Tuple[str, float]]:
    """Idle device seconds in the window, summed by what the host was
    doing at each gap's midpoint: the harness span, then the innermost
    host event inside it."""
    gaps = []
    t = w0
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if t < w1:
        gaps.append((t, w1))
    spans = sorted(((s, e, n) for n, s, e in host if n in SPANS
                    and n != WINDOW), key=lambda x: x[0])
    inner = sorted(((s, e, n) for n, s, e in host if n not in SPANS),
                   key=lambda x: x[0])
    span_starts = [s for s, _, _ in spans]
    inner_starts = [s for s, _, _ in inner]
    out: Dict[str, float] = {}
    for a, b in gaps:
        mid = (a + b) // 2
        label = _covering(spans, span_starts, mid) or "outside any span"
        op = _covering(inner, inner_starts, mid, innermost=True)
        key = f"{label}: {op}" if op else label
        out[key] = out.get(key, 0.0) + (b - a) / 1e9
    return sorted(out.items(), key=lambda kv: -kv[1])


def _covering(items, starts, t: int, innermost: bool = False):
    """The name of the item (start, end, name) covering ``t``: the
    latest-starting one when ``innermost``, else the earliest found among
    the few that start last before ``t``."""
    i = bisect.bisect_right(starts, t) - 1
    found = None
    # look back over a bounded number of earlier starts for one covering t
    for j in range(i, max(-1, i - 64), -1):
        s, e, n = items[j]
        if s <= t < e:
            found = n
            if innermost:
                break
    return found


def host_ms_per_step(s: Summary) -> Optional[float]:
    """Host milliseconds a step outside waits: the window's wall less the
    time blocked in CUDA syncs and in waiting for arrivals, over the
    engine steps (serving_profile's arithmetic, the arrival waits added)."""
    if not s.steps:
        return None
    return (s.window_s - s.sync_s - s.wait_s) * 1e3 / s.steps


def idle_share(s: Optional[Summary]) -> Optional[float]:
    """Percent of the traced window with no device operation running, or
    None where the trace saw no device operation."""
    if s is None or not s.device_events or s.window_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)
