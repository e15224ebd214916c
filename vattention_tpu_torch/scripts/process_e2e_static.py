"""Summarize static-trace results into the reference's makespan table and
comparison figure.

Twin of ``scripts/process_e2e_static.py:32-119`` (ref process_e2e_static.py:
20-27: makespan = max request e2e time over the equal-length requests, per
(model, ctx, P:D), with the best vattn backend's speedup over the best
paged one): the same tab-separated table on stdout, from the flat
``benchmark_e2e_static_trace`` rows or the collector's
``grid_results.json`` (``{"configs": [...]}``).  ``--plot [out.png]``
draws the grouped-bar figure with matplotlib, imported only then; where it
is not installed (the card's host) ``--plot`` raises.

Usage:
  python -m vattention_tpu_torch.scripts.process_e2e_static \\
      [results.json] [--plot out.png]
"""

from __future__ import annotations

import argparse
import itertools
import json
from collections import defaultdict

from vattention_tpu_torch.scripts.common import add_device_arg, resolve

# fixed backend -> hue assignment (entity-stable palette)
BACKEND_COLORS = {
    "fa_vattn_2mb": "#2a78d6",     # blue
    "fa_vattn_256kb": "#1baf7a",   # aqua
    "fa_paged_256": "#eb6834",     # orange
    "fa_paged_16": "#eda100",      # yellow
    "fa_pod": "#e87ba4",           # magenta
}
FALLBACK_COLORS = ["#008300", "#4a3aa7", "#8c8c84"]


def pyplot():
    """matplotlib's pyplot on the Agg backend; raises where matplotlib is
    not installed."""
    try:
        import matplotlib
    except ImportError as e:
        raise RuntimeError("--plot needs matplotlib, which is not installed "
                           "here; run without --plot, or plot the JSON on a "
                           "host that has it") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot(grid, backends, out_path):
    plt = pyplot()
    keys = sorted(grid.keys())
    fig, ax = plt.subplots(figsize=(1.4 + 1.3 * len(keys), 3.6))
    width = 0.8 / max(len(backends), 1)
    extras = itertools.cycle(FALLBACK_COLORS)
    for i, b in enumerate(backends):
        xs, ys = [], []
        for k, key in enumerate(keys):
            if b in grid[key]:
                xs.append(k + (i - (len(backends) - 1) / 2) * width)
                ys.append(grid[key][b])
        base = b
        for suf in ("_fp8", "_int8", "_tuned", "_512q256", "_c4k"):
            base = base.replace(suf, "")
        color = BACKEND_COLORS.get(base, None) or next(extras)
        bars = ax.bar(xs, ys, width=width * 0.92, label=b, color=color,
                      edgecolor="white", linewidth=1)
        if "fp8" in b:
            for bar in bars:
                bar.set_hatch("//")
    ax.set_xticks(range(len(keys)))
    ax.set_xticklabels(
        [f"{ctx//1024}K\nP:D {pd}" for (_, ctx, pd) in keys],
        fontsize=8, color="#40403e")
    ax.set_ylabel("makespan (s, lower is better)", fontsize=9,
                  color="#40403e")
    ax.legend(fontsize=8, frameon=False)
    ax.spines[["top", "right"]].set_visible(False)
    ax.tick_params(colors="#8c8c84")
    ax.yaxis.grid(True, color="#e8e8e4", linewidth=0.8)
    ax.set_axisbelow(True)
    fig.tight_layout()
    fig.savefig(out_path, dpi=160)
    print(f"wrote {out_path}")


def table(rows) -> tuple:
    """(grid {(model, ctx, pd): {label: makespan}}, labels, table lines)."""
    grid = defaultdict(dict)
    for r in rows:
        key = (r.get("model", "-"), r["ctx"], r["pd_ratio"])
        # wide-tile control cells keep their own column
        w = r.get("wide_tile")
        label = r["backend"] + (
            "" if not w else f"_{w}" if isinstance(w, str) else f"_w{w}")
        grid[key][label] = r["makespan_s"]

    backends = sorted({b for per in grid.values() for b in per})
    lines = ["\t".join(["model", "ctx", "P:D"] + backends
                       + ["best_vattn_speedup"])]
    for (model, ctx, pd), per_backend in sorted(grid.items()):
        paged = [v for b, v in per_backend.items()
                 if "paged" in b and "fp8" not in b]
        vattn = [v for b, v in per_backend.items()
                 if "vattn" in b and "fp8" not in b]
        speedup = (min(paged) / min(vattn)
                   if paged and vattn and min(vattn) > 0 else float("nan"))
        cells = [model, str(ctx), str(pd)]
        cells += [f"{per_backend.get(b, float('nan')):.2f}"
                  for b in backends]
        cells.append(f"{speedup:.3f}x")
        lines.append("\t".join(cells))
    return grid, backends, lines


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("path", nargs="?",
                   default="benchmark_output/e2e_static.json")
    p.add_argument("--plot", nargs="?", default=None,
                   const="benchmark_output/e2e_static_makespan.png")
    return add_device_arg(p)


def main(argv=None) -> list:
    args = parser().parse_args(argv)
    resolve(args.device)
    with open(args.path) as f:
        rows = json.load(f)
    if isinstance(rows, dict):  # the collector's grid_results.json
        rows = rows["configs"]
    grid, backends, lines = table(rows)
    print("\n".join(lines))
    if args.plot:
        plot(grid, backends, args.plot)
    return lines


if __name__ == "__main__":
    main()
