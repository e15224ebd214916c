"""Time the layer's elementwise kernels (``ops/norm_act.py``) call by call.

    python -m vattention_tpu_torch.microbenchmarks.bench_norm_act \\
        --model falcon-7b yi-6b-200k --rows 520 2048 --calls 40

For each model's widths (the llama family's add_rms_norm over [T, H] and
silu_and_mul over [T, 2I]; falcon's add_layer_norm of x + (o + mlp) and
gelu_new over [T, I]), each ``--rows`` T and each ``--dtype``: the
kernel's output is first held against its plain version
(``timing.check_elementwise``; the residual bit for bit), then
``--calls`` single calls are timed with ``timing.Timer`` (each after an L2
flush), in turns with single calls of the plain version.  One line per
case: the min, median and max ms of those calls for the kernel and the
plain version, and the kernel's bytes bound at 3.35 TB/s (each input read
once, each output written once), so one slow call shows as a max far
above the median.  Inputs: seeded normal rows (x of mean 0.5, the
addends 0.7, gates to +-12), as chip_smoke (a norm) draws them.

With ``--device cpu`` the plain versions run at a tiny width (H 256, I
688, at most 8 rows and 3 calls) and times are host wall clock; without
a GPU it raises unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import sys
from typing import List

import torch

from vattention_tpu_torch.config import get_model_arch
from vattention_tpu_torch.microbenchmarks.timing import (Timer, bound,
                                                         check_elementwise,
                                                         harness_device)
from vattention_tpu_torch.ops import norm_act

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
LN_EPS = 1e-5   # falcon's LayerNorm epsilon
CPU_WIDTHS = (256, 688)
CPU_MAX = dict(rows=8, calls=3)


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model", nargs="+", default=["yi-6b-200k", "falcon-7b"])
    p.add_argument("--rows", nargs="+", type=int, default=[1, 8, 520, 2048])
    p.add_argument("--dtype", nargs="+", choices=sorted(DTYPES),
                   default=["bf16", "f32"])
    p.add_argument("--calls", type=int, default=40)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return p


def cases(arch, T: int, H: int, inter: int, dt, dev):
    """(name, kernel call, plain call, bytes) for one model, T and dtype."""
    gen = torch.Generator(device=dev).manual_seed(16)

    def randn(*shape, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale
                + shift).to(dt)
    w, b = randn(H, scale=0.2, shift=1), randn(H, scale=0.1)
    x, o, m = (randn(T, H, scale=2, shift=0.5), randn(T, H, scale=0.7),
               randn(T, H, scale=0.7))
    es = x.element_size()
    if arch.parallel_attn:
        u = randn(T, inter, scale=3)
        return [
            ("add_layer_norm",
             lambda: norm_act.add_layer_norm(x, o, m, w, b, LN_EPS),
             lambda: norm_act.add_layer_norm_plain(x, o, m, w, b, LN_EPS),
             (5 * T * H + 2 * H) * es),
            ("gelu_new", lambda: norm_act.gelu_new(u),
             lambda: norm_act.gelu_new_plain(u), 2 * T * inter * es)]
    g = randn(T, 2 * inter, scale=4)
    eps = arch.rms_norm_eps
    return [
        ("add_rms_norm", lambda: norm_act.add_rms_norm(x, o, w, eps),
         lambda: norm_act.add_rms_norm_plain(x, o, w, eps),
         (4 * T * H + H) * es),
        ("silu_and_mul", lambda: norm_act.silu_and_mul(g),
         lambda: norm_act.silu_and_mul_plain(g), 3 * T * inter * es)]


def spread(times: List[float]) -> str:
    s = sorted(times)
    return f"{s[0]:.4f} / {s[len(s) // 2]:.4f} / {s[-1]:.4f}"


def run(args) -> None:
    dev = harness_device(args.device == "cpu")
    cpu = dev.type == "cpu"
    if cpu:
        args.rows = sorted({min(t, CPU_MAX["rows"]) for t in args.rows})
        args.calls = min(args.calls, CPU_MAX["calls"])
    timer = Timer(dev)
    print("kernel,model,dtype,T,kernel ms min / median / max,"
          "plain ms min / median / max,bound ms", flush=True)
    for model in args.model:
        arch = get_model_arch(model)
        H, inter = ((arch.hidden_size, arch.intermediate_size) if not cpu
                    else CPU_WIDTHS)
        for name_dt in args.dtype:
            dt = DTYPES[name_dt]
            for T in args.rows:
                for name, fn, plain, n_bytes in cases(arch, T, H, inter, dt,
                                                      dev):
                    got, ref = fn(), plain()
                    if isinstance(got, tuple):
                        if not torch.equal(got[0], ref[0]):
                            raise AssertionError(f"{name}: the residual "
                                                 "differs from the plain add")
                        got, ref = got[1], ref[1]
                    check_elementwise(name, got, ref)
                    ms, plain_ms = [], []
                    for _ in range(args.calls):
                        ms.append(timer(fn, iters=1, warmup=0))
                        plain_ms.append(timer(plain, iters=1, warmup=0))
                    print(f"{name},{model},{name_dt},{T},{spread(ms)},"
                          f"{spread(plain_ms)},{bound(n_bytes, 0)[0]:.5f}",
                          flush=True)


def main(argv=None) -> int:
    run(parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
