"""Readings for the limits that decide ``correct``, and the knee of an open loop.

Not run by the benchmark's own runs.  Each reading is one run of
``run.execute`` in this process (set-up shared: the kernels' libraries and
the CUDA context), so a dozen seeds of a cell cost one set-up each of
the engine and no more:

    # the program's readings over seeds, then the control's: the program
    # with its 1-byte K/V (e4m3) switched on
    python3 -m port_bench.calibrate --workload yi6b.prefill-long \\
        --seeds 11 12 13 --seconds 45 --control fp8 --out chiprun_out/cal

    # the knee: the open loop's rate swept, no comparison
    python3 -m port_bench.calibrate --workload yi6b.arxiv-poisson \\
        --seeds 11 --seconds 45 --rates 2 2.5 3 3.5 4 --out chiprun_out/knee

``--control`` alone reads the control only; ``--program`` adds the
program's readings before it.  Each reading is a line of JSON on
standard output and in ``<out>/<workload>.jsonl``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

from port_bench import run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", default=None,
                    help="the program's 1-byte K/V to read as the control "
                         "(fp8 or int8)")
    ap.add_argument("--program", action="store_true",
                    help="read the program too (first)")
    ap.add_argument("--rates", type=float, nargs="*", default=None,
                    help="sweep the open loop's rate (no comparison)")
    ap.add_argument("--out", default="chiprun_out/calibrate")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("error: needs a CUDA device", file=sys.stderr)
        return 2
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    sink = open(out / f"{args.workload}.jsonl", "a")

    def emit(row: dict) -> None:
        line = json.dumps(row)
        print(line, flush=True)
        sink.write(line + "\n")
        sink.flush()

    runs = []
    if args.rates:
        runs = [("program", None, {"rate": r}) for r in args.rates]
    else:
        if args.program or args.control is None:
            runs.append(("program", None, None))
        if args.control is not None:
            runs.append(("control", args.control, None))
    for label, kv_quant, overrides in runs:
        for seed in args.seeds:
            t = time.monotonic()
            result, info = run.execute(
                args.workload, seed, args.seconds, False,
                kv_quant=kv_quant, do_check=not args.rates,
                traffic_overrides=overrides, t_start=t)
            emit({"workload": args.workload, "as": label, "seed": seed,
                  "overrides": overrides, "wall_s": time.monotonic() - t,
                  "info": info, **result})
    sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
