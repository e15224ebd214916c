"""Summarize dynamic-trace results: normalized e2e percentiles against QPS.

Twin of ``scripts/process_e2e_dynamic.py:18-77`` (ref process_e2e_dynamic.py:
19-26: per backend and arrival rate, p50/p90/p99 of request e2e time
normalized by output length): the same tab-separated table from
``benchmark_e2e_dynamic_trace``'s output (its ``meta`` printed first as
``# invocation``).  ``--plot [out.png]`` draws the percentile-against-QPS
figure with matplotlib, imported only then; where it is not installed
``--plot`` raises.

Usage:
  python -m vattention_tpu_torch.scripts.process_e2e_dynamic \\
      [results.json] [--plot out.png]
"""

from __future__ import annotations

import argparse
import json

from vattention_tpu_torch.scripts.common import add_device_arg, resolve
from vattention_tpu_torch.scripts.process_e2e_static import (
    BACKEND_COLORS, FALLBACK_COLORS, pyplot)


def plot(rows, out_path):
    plt = pyplot()
    backends = sorted({r["backend"] for r in rows})
    fig, axes = plt.subplots(1, 2, figsize=(8.4, 3.4), sharex=True)
    extras = iter(FALLBACK_COLORS)
    colors = {b: BACKEND_COLORS.get(b.replace("_fp8", ""))
              or next(extras) for b in backends}
    for ax, pct, title in ((axes[0], "normalized_e2e_p50", "p50"),
                           (axes[1], "normalized_e2e_p99", "p99")):
        for b in backends:
            pts = sorted(((r["qps"], r[pct]) for r in rows
                          if r["backend"] == b))
            ax.plot([p[0] for p in pts], [p[1] for p in pts],
                    marker="o", markersize=4, linewidth=2,
                    label=b, color=colors[b])
        ax.set_title(f"normalized e2e {title} (s/token, lower is "
                     "better)", fontsize=9, color="#40403e")
        ax.set_xlabel("arrival rate (qps)", fontsize=9, color="#40403e")
        ax.spines[["top", "right"]].set_visible(False)
        ax.tick_params(colors="#8c8c84", labelsize=8)
        ax.yaxis.grid(True, color="#e8e8e4", linewidth=0.8)
        ax.set_axisbelow(True)
    axes[0].legend(fontsize=8, frameon=False)
    fig.tight_layout()
    fig.savefig(out_path, dpi=160)
    print(f"wrote {out_path}")


def table(rows) -> list:
    lines = ["backend\tqps\tnorm_e2e_p50\tnorm_e2e_p90\tnorm_e2e_p99\t"
             "sched_delay_p99\ttok/s"]
    for r in sorted(rows, key=lambda r: (r["backend"], r["qps"])):
        lines.append(f"{r['backend']}\t{r['qps']}\t"
                     f"{r['normalized_e2e_p50']:.4f}\t"
                     f"{r['normalized_e2e_p90']:.4f}\t"
                     f"{r['normalized_e2e_p99']:.4f}\t"
                     f"{r['scheduling_delay_p99']:.3f}\t"
                     f"{r['tokens_per_s']:.1f}")
    return lines


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("path", nargs="?",
                   default="benchmark_output/e2e_dynamic.json")
    p.add_argument("--plot", nargs="?", default=None,
                   const="benchmark_output/e2e_dynamic_percentiles.png")
    return add_device_arg(p)


def main(argv=None) -> list:
    args = parser().parse_args(argv)
    resolve(args.device)
    with open(args.path) as f:
        rows = json.load(f)
    if isinstance(rows, dict):  # the self-describing artifact
        if rows.get("meta"):
            print("# invocation:", json.dumps(rows["meta"]))
        rows = rows["results"]
    lines = table(rows)
    print("\n".join(lines))
    if args.plot:
        plot(rows, out_path=args.plot)
    return lines


if __name__ == "__main__":
    main()
