"""Time the layer's elementwise kernels (``ops/norm_act.py``) call by call.

    python -m vattention_tpu_torch.microbenchmarks.bench_norm_act \\
        --model falcon-7b yi-6b-200k --rows 520 2048 --calls 40

For each model's widths (the llama family's add_rms_norm over [T, H] and
silu_and_mul over [T, 2I]; falcon's add_layer_norm of x + (o + mlp) and
gelu_new over [T, I]), each ``--rows`` T and each ``--dtype``: the
kernel's output is first held against its plain version
(``timing.check_elementwise``; the residual bit for bit), then
``--calls`` single calls are timed with ``timing.Timer`` (each after an L2
flush), in turns with single calls of the plain version and of three
yardsticks: a ``copy_`` that moves the kernel's bytes (half read, half
written: what a memory-bound kernel of these bytes costs under this
timer), a ``copy_`` of 16 bytes (the timer's floor: one launch and one
dependent DRAM round trip) and the library call that computes the same
function (``F.rms_norm`` after the add, ``F.silu(g) * u``,
``F.layer_norm`` after the adds, ``F.gelu(approximate="tanh")``), as
chip_smoke (a norm) times it.  One line per case: the min, median and
max ms of those calls for the kernel, the plain version and the
yardsticks, and the kernel's bytes bound at 3.35 TB/s (each input read
once, each output written once), so one slow call shows as a max far
above the median.  Inputs: seeded normal rows (x of mean 0.5, the
addends 0.7, gates to +-12), as chip_smoke (a norm) draws them.

With ``--plans`` (on the card) add_rms_norm, silu_and_mul and gelu_new
are also timed under every launch plan their source takes (add_rms_norm:
1, 2, 4 or 8 vectors a thread, the fewest warps that fit the row, 1-8
rows a block; silu_and_mul: 1 or 2 gate/up pairs a thread in blocks of
64, 128 or 256 threads; gelu_new: 1, 2 or 4 vectors a thread in blocks of
64, 128 or 256 over the flat tensor), one line ``plan,kernel,model,
dtype,T,vpt x threads x rows a block (tiles; gelu_new: blocks),ms min /
median / max,chosen`` each, ``chosen`` 1 for the plan the wrapper takes
(``norm_act.norm_plan``, ``silu_plan``, ``gelu_plan``).

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
from vattention_tpu_torch.ops.cuda_build import DTYPE_CODES, current_stream

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
# every hidden and MLP width of the model registry (config.py), and the
# rows the launch plans are held at: a decode row, small batches, a ragged
# count, (a)'s step and a 2048-token chunk (chip_smoke (a norm) and the
# tests hold add_rms_norm and silu_and_mul at each)
HIDDEN_WIDTHS = (256, 768, 4096, 4544, 5120, 7168, 8192)
MLP_WIDTHS = (688, 3072, 11008, 13696, 13824, 14336, 18176, 20480, 28672)
PLAN_ROWS = (1, 2, 3, 8, 16, 127, 520, 2048)
LN_EPS = 1e-5   # falcon's LayerNorm epsilon
CPU_WIDTHS = (256, 688)
CPU_MAX = dict(rows=8, calls=3)
# the wrapper's plan of each kernel that --plans sweeps, at (T, width,
# element size, SMs)
PLAN_OF = {"add_rms_norm": norm_act.norm_plan,
           "silu_and_mul": norm_act.silu_plan,
           "gelu_new": lambda T, width, es, sms: norm_act.gelu_plan(
               T * width, es)}


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model", nargs="+", default=["yi-6b-200k", "falcon-7b"])
    p.add_argument("--rows", nargs="+", type=int, default=[1, 8, 520, 2048])
    p.add_argument("--dtype", nargs="+", choices=sorted(DTYPES),
                   default=["bf16", "f32"])
    p.add_argument("--calls", type=int, default=40)
    p.add_argument("--plans", action="store_true",
                   help="also time add_rms_norm, silu_and_mul and "
                        "gelu_new under every launch plan their source "
                        "takes")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return p


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def plans(name: str, T: int, width: int, element_size: int):
    """Every launch plan the source takes for ``name`` over [T, width]:
    add_rms_norm's (vpt, row_threads, rows_per_block), silu_and_mul's
    (vpt, threads, tiles), gelu_new's (vpt, threads, blocks)."""
    nvec = width * element_size // 16
    if name == "add_rms_norm":
        for vpt in (1, 2, 4, norm_act.MAX_VECS):
            rt = _cdiv(_cdiv(nvec, vpt), 32) * 32
            for rpb in (1, 2, 4, 8):
                if rt * rpb <= norm_act.NORM_THREADS and rpb <= T:
                    yield vpt, rt, rpb
    elif name == "gelu_new":
        for vpt in (1, 2, norm_act.MAX_GELU_VECS):
            for threads in (64, 128, 256):
                yield vpt, threads, _cdiv(T * nvec, threads * vpt)
    else:
        for vpt in (1, norm_act.MAX_ACT_VECS):
            for threads in (64, 128, 256):
                yield vpt, threads, _cdiv(nvec, threads * vpt)


def with_plan(name: str, plan, x, r, w, eps, g, u=None):
    """One launch of ``name`` under ``plan`` (no checks: ``plans`` makes
    only plans the source takes)."""
    if name == "add_rms_norm":
        res, out = torch.empty_like(x), torch.empty_like(x)
        norm_act.ADD_RMS_NORM(res.data_ptr(), out.data_ptr(), x.data_ptr(),
                              r.data_ptr(), w.data_ptr(), *x.shape, eps,
                              DTYPE_CODES[x.dtype], *plan, current_stream())
        return
    if name == "gelu_new":
        out = torch.empty_like(u)
        norm_act.GELU_NEW(out.data_ptr(), u.data_ptr(), u.numel(),
                          DTYPE_CODES[u.dtype], *plan, current_stream())
        return
    out = torch.empty((g.shape[0], g.shape[1] // 2), dtype=g.dtype,
                      device=g.device)
    norm_act.SILU_AND_MUL(out.data_ptr(), g.data_ptr(), g.shape[0],
                          g.shape[1] // 2, DTYPE_CODES[g.dtype], *plan,
                          current_stream())


def cases(arch, T: int, H: int, inter: int, dt, dev):
    """(name, kernel call, plain call, library call, bytes, its call
    under a plan or None) for one model, T and dtype."""
    F = torch.nn.functional
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
             lambda: F.layer_norm(x + (o + m), (H,), w, b, LN_EPS),
             (5 * T * H + 2 * H) * es, None),
            ("gelu_new", lambda: norm_act.gelu_new(u),
             lambda: norm_act.gelu_new_plain(u),
             lambda: F.gelu(u, approximate="tanh"), 2 * T * inter * es,
             lambda plan: with_plan("gelu_new", plan, x, o, None, None,
                                    None, u))]
    g = randn(T, 2 * inter, scale=4)
    eps = arch.rms_norm_eps
    return [
        ("add_rms_norm", lambda: norm_act.add_rms_norm(x, o, w, eps),
         lambda: norm_act.add_rms_norm_plain(x, o, w, eps),
         lambda: F.rms_norm(x + o, (H,), w, eps), (4 * T * H + H) * es,
         lambda plan: with_plan("add_rms_norm", plan, x, o, w, eps, g)),
        ("silu_and_mul", lambda: norm_act.silu_and_mul(g),
         lambda: norm_act.silu_and_mul_plain(g),
         lambda: F.silu(g[:, :inter]) * g[:, inter:], 3 * T * inter * es,
         lambda plan: with_plan("silu_and_mul", plan, x, o, w, eps, g))]


def spread(times: List[float]) -> str:
    s = sorted(times)
    return f"{s[0]:.4f} / {s[len(s) // 2]:.4f} / {s[-1]:.4f}"


def run(args) -> None:
    dev = harness_device(args.device == "cpu")
    cpu = dev.type == "cpu"
    if cpu and args.plans:
        raise ValueError("--plans times the CUDA kernels: not with --device "
                         "cpu")
    if cpu:
        args.rows = sorted({min(t, CPU_MAX["rows"]) for t in args.rows})
        args.calls = min(args.calls, CPU_MAX["calls"])
    timer = Timer(dev)
    print("kernel,model,dtype,T,kernel ms min / median / max,"
          "plain ms min / median / max,bound ms,"
          "copy of its bytes ms min / median / max,"
          "copy of 16 bytes ms min / median / max,"
          "library ms min / median / max", flush=True)
    tiny = torch.empty(2, 16, dtype=torch.uint8, device=dev)
    for model in args.model:
        arch = get_model_arch(model)
        H, inter = ((arch.hidden_size, arch.intermediate_size) if not cpu
                    else CPU_WIDTHS)
        for name_dt in args.dtype:
            dt = DTYPES[name_dt]
            for T in args.rows:
                for name, fn, plain, lib, n_bytes, planned in cases(
                        arch, T, H, inter, dt, dev):
                    got, ref = fn(), plain()
                    if isinstance(got, tuple):
                        if not torch.equal(got[0], ref[0]):
                            raise AssertionError(f"{name}: the residual "
                                                 "differs from the plain add")
                        got, ref = got[1], ref[1]
                    check_elementwise(name, got, ref)
                    pair = torch.empty(2, n_bytes // 2, dtype=torch.uint8,
                                       device=dev)
                    calls = {"kernel": fn, "plain": plain,
                             "copy": lambda: pair[1].copy_(pair[0]),
                             "floor": lambda: tiny[1].copy_(tiny[0]),
                             "library": lib}
                    ms = {k: [] for k in calls}
                    for _ in range(args.calls):
                        for k, call in calls.items():
                            ms[k].append(timer(call, iters=1, warmup=0))
                    del pair
                    print(f"{name},{model},{name_dt},{T},"
                          f"{spread(ms['kernel'])},{spread(ms['plain'])},"
                          f"{bound(n_bytes, 0)[0]:.5f},{spread(ms['copy'])},"
                          f"{spread(ms['floor'])},{spread(ms['library'])}",
                          flush=True)
                    if not args.plans or planned is None:
                        continue
                    width = H if name == "add_rms_norm" else inter
                    es = torch.empty((), dtype=dt).element_size()
                    sms = torch.cuda.get_device_properties(
                        dev).multi_processor_count
                    chosen = tuple(PLAN_OF[name](T, width, es, sms))[:3]
                    for plan in plans(name, T, width, es):
                        times = [timer(lambda: planned(plan), iters=1,
                                       warmup=0) for _ in range(args.calls)]
                        print(f"plan,{name},{model},{name_dt},{T},"
                              f"{' x '.join(map(str, plan))},"
                              f"{spread(times)},{int(plan == chosen)}",
                              flush=True)


def main(argv=None) -> int:
    run(parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
