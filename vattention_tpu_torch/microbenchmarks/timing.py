"""What ``chip_smoke.py`` and the harnesses of this package share, so they
make inputs, time and check the same way: the device, seeded inputs,
kernel timing, roofline bounds and the attention tolerance.

On the card a time is the mean device milliseconds of one call over CUDA
events, each call after a 256 MB L2 flush (a serving step meets every
layer's KV cold) and a short device-side wait, so the host's work of
enqueueing the call (the wrapper's checks) is done before the start
event and is not counted as device time.  ``VATTN_TIMER=enqueue`` in the
environment leaves the wait out: the host's enqueue time then counts
wherever it outlasts the flush, which is how a call's cost to a serving
step that is host bound reads, and how trees without the wait timed.
With ``--cpu`` a harness runs the kernels' plain versions at tiny shapes,
and ``Timer`` then gives host wall-clock milliseconds: not a device time.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

PEAK_BYTES_PER_S = 3.35e12    # H100 SXM HBM3
PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16 tensor cores
# prefill and decode attention against a plain version: atol = rtol (one
# bf16 rounding of outputs of magnitude ~1, summed in another order), and
# max |kernel - plain| in each output row (one query token or decode slot,
# all heads) as a fraction of that row's largest |plain| output: rounding
# P and the output to bf16 moves a row by about one bf16 step (2^-7) of
# its largest value, while a dropped key tile or a causal mask off by one
# moves deep rows, whose outputs are small, by several percent
ATTN_TOL = 2e-2
REL_TOL = 2.0 ** -6
# the norms and activations (ops/norm_act.py) against their plain
# versions: within ELEMENTWISE_TOL of the output's largest value (float32
# sums taken in another order; a LayerNorm's x - mean cancels near the
# mean), and a bfloat16 output also within one bfloat16 ulp of each value
ELEMENTWISE_TOL = 1e-6


def harness_device(cpu: bool) -> torch.device:
    """The card, or the CPU when ``cpu``; raises when there is no card and
    the CPU was not asked for."""
    if cpu:
        print("--cpu: the kernels' plain versions on the CPU; times are "
              "host wall clock, not device times", file=sys.stderr)
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: run on the card, or pass --cpu "
                           "for the plain versions on the CPU")
    return torch.device("cuda", 0)


def cap_for_cpu(args, caps: dict) -> None:
    """Cut each argument named in ``caps`` to at most its cap (a list
    argument element-wise, without repeats)."""
    for name, cap in caps.items():
        v = getattr(args, name)
        setattr(args, name, sorted({min(x, cap) for x in v})
                if isinstance(v, list) else min(v, cap))


def seeded(device, seed: int = 0):
    """``(randn, i32)`` on ``device``: ``randn(*shape)`` draws bf16
    standard-normal tensors from one generator seeded with ``seed``;
    ``i32(x)`` makes an int32 tensor of an array-like."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device,
                           dtype=torch.float32).to(torch.bfloat16)

    def i32(x):
        return torch.as_tensor(np.asarray(x, np.int32), device=device)

    return randn, i32


def check_attention(what, got, ref, tol: float = ATTN_TOL,
                    scale: float = 1.0):
    """Hold ``got`` against ``ref`` ([rows, Hq, D]) within atol = rtol =
    ``tol`` and each row within REL_TOL of its largest |ref|; returns the
    max abs err and the largest row's err / max |ref|.  Both are first
    multiplied by ``scale``: an int8 arena's outputs count in its steps
    until the backend's one multiply by the step."""
    got, ref = got.float() * scale, ref.float() * scale
    torch.testing.assert_close(got, ref, atol=tol, rtol=tol,
                               msg=lambda m: f"{what}: {m}")
    err = (got - ref).abs().flatten(1).amax(1)
    scale = ref.abs().flatten(1).amax(1)
    rel = (err / scale.clamp_min(1e-30)).max().item()
    if not rel <= REL_TOL:
        raise AssertionError(f"{what}: a row errs by {rel} of its largest "
                             f"output, above {REL_TOL}")
    return err.max().item(), rel


def check_elementwise(what, got, ref) -> float:
    """Hold a norm's or an activation's output ``got`` against ``ref``
    (the same dtype and shape): each value within ELEMENTWISE_TOL of its
    own size or of ``ref``'s largest |value|, or, in bfloat16, within one
    bfloat16 ulp of itself.  Returns the max abs err."""
    if got.shape != ref.shape or got.dtype != ref.dtype:
        raise AssertionError(f"{what}: {got.dtype} {tuple(got.shape)} "
                             f"against {ref.dtype} {tuple(ref.shape)}")
    if ref.numel() == 0:
        return 0.0
    bf16 = got.dtype == torch.bfloat16
    got, ref = got.float(), ref.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: non-finite outputs")
    err = (got - ref).abs()
    tol = (ELEMENTWISE_TOL * ref.abs()).clamp_min(
        ELEMENTWISE_TOL * float(ref.abs().max()))
    if bf16:
        mag = torch.maximum(got.abs(), ref.abs()).clamp_min(2.0 ** -126)
        tol = torch.maximum(tol, torch.exp2(torch.floor(torch.log2(mag)) - 7))
    bad = err > tol
    if bad.any():
        raise AssertionError(f"{what}: {int(bad.sum())} values past the "
                             f"tolerance, max err {float(err.max())}")
    return float(err.max())


class Timer:
    """Mean milliseconds of ``fn`` over ``iters`` calls after ``warmup``
    calls: device time on the card, each call after an L2 flush and a
    device-side wait of ``HOST_SLACK_CYCLES`` clock cycles (the host
    enqueues the call meanwhile; none under ``VATTN_TIMER=enqueue``); host
    wall clock on the CPU."""

    HOST_SLACK_CYCLES = 1_000_000   # ~0.5 ms at the H100's clocks

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.wait = os.environ.get("VATTN_TIMER") != "enqueue"
        self.mode = ("device: L2 flush, then a device-side wait while the "
                     "host enqueues" if self.wait else
                     "enqueue: L2 flush only, host enqueue time past it "
                     "counts")
        self.flush_buf = (torch.empty(256 * 2**20, dtype=torch.uint8,
                                      device=device) if self.cuda else None)

    def __call__(self, fn, iters: int = 10, warmup: int = 2) -> float:
        for _ in range(warmup):
            fn()
        if not self.cuda:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            return (time.perf_counter() - t0) * 1e3 / iters
        total = 0.0
        for _ in range(iters):
            self.flush_buf.zero_()
            if self.wait:
                torch.cuda._sleep(self.HOST_SLACK_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            total += start.elapsed_time(end)
        return total / iters


def bound(n_bytes: float, flops: float):
    """(least milliseconds on the H100, "bytes" or "operations"): the
    larger of ``n_bytes`` over the memory rate and ``flops`` over the bf16
    tensor-core rate."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
