"""Render the long-context grid's markdown tables from grid_results.json.

Twin of ``scripts/render_perf_tables.py:19-111``: the same tables, so every
published cell is derived from a results file.  The main table holds the
yi cells (fa_vattn_2mb, fa_vattn_256kb, fa_paged_256, fa_paged_256_w512,
fa_paged_16, fa_pod) with the best vattn's ratio against fa_paged_256 and
against the strongest paged cell; then the quantized pairs, the tuned
frontier (none from the port's grid), the second geometries and the
decomposition, each where the results have rows for it.

Usage:
  python -m vattention_tpu_torch.scripts.render_perf_tables \\
      [benchmark_output/longctx/grid_results.json]
"""

from __future__ import annotations

import argparse
import json
from collections import defaultdict

from vattention_tpu_torch.scripts.common import add_device_arg, resolve


def fmt(v):
    return f"{v:.1f}" if isinstance(v, (int, float)) else "—"


def label(r):
    w = r.get("wide_tile")
    return r["backend"] + (
        "" if not w else f"_{w}" if isinstance(w, str) else f"_w{w}")


def render(data) -> list:
    rows = data["configs"] if isinstance(data, dict) else data
    grid = defaultdict(dict)
    for r in rows:
        grid[(r["model"], r["ctx"], r["pd_ratio"])][label(r)] = \
            r["makespan_s"]
    out = []

    # main table: yi model, the named columns
    cols = ["fa_vattn_2mb", "fa_vattn_256kb", "fa_paged_256",
            "fa_paged_256_w512", "fa_paged_16", "fa_pod"]
    out.append("| ctx | P:D | " + " | ".join(cols)
               + " | best vattn vs paged-256 | vs strongest paged |")
    out.append("|" + "---|" * (len(cols) + 4))
    for (model, ctx, pd), per in sorted(grid.items()):
        if model != "yi":
            continue
        base = {b: v for b, v in per.items()
                if "fp8" not in b and "int8" not in b}
        if not base:
            continue
        vattn = [v for b, v in base.items()
                 if "vattn" in b and "tuned" not in b]
        paged_all = [v for b, v in base.items()
                     if "paged" in b and "tuned" not in b]
        plain = base.get("fa_paged_256")
        r1 = (f"{plain / min(vattn):.2f}x"
              if plain and vattn else "—")
        r2 = (f"{min(paged_all) / min(vattn):.2f}x"
              if paged_all and vattn else "—")
        out.append(f"| {ctx // 1024}K | {pd} | "
                   + " | ".join(fmt(base.get(c)) for c in cols)
                   + f" | {r1} | {r2} |")

    qrows = [(k, per) for k, per in sorted(grid.items())
             if any("fp8" in b or "int8" in b for b in per)]
    if qrows:
        out += ["", "Quantized pairs (both engines quantized):", "",
                "| ctx | P:D | kv | fa_vattn_2mb | fa_paged_256 | ratio |",
                "|---|---|---|---|---|---|"]
        for (model, ctx, pd), per in qrows:
            for q in ("fp8", "int8"):
                v = per.get(f"fa_vattn_2mb_{q}")
                p = per.get(f"fa_paged_256_{q}")
                if v and p:
                    out.append(f"| {ctx // 1024}K | {pd} | {q} | {fmt(v)} "
                               f"| {fmt(p)} | {p / v:.2f}x |")

    trows = [(k, per) for k, per in sorted(grid.items())
             if any("tuned" in b for b in per)]
    if trows:
        out += ["", "Tuned-tiling frontier (1024-wide kv + 256-row q tiles,"
                " both engines):", "",
                "| ctx | P:D | vattn tuned | paged tuned | ratio "
                "| vattn default |", "|---|---|---|---|---|---|"]
        for (model, ctx, pd), per in trows:
            v = per.get("fa_vattn_2mb_tuned")
            p = per.get("fa_paged_256_tuned")
            d = per.get("fa_vattn_2mb")
            if v and p:
                out.append(f"| {ctx // 1024}K | {pd} | {fmt(v)} | {fmt(p)} "
                           f"| {p / v:.2f}x | {fmt(d)} |")

    mrows = [(k, per) for k, per in sorted(grid.items()) if k[0] != "yi"]
    if mrows:
        out += ["", "Second geometries (A/B not shape-tuned):", "",
                "| model | ctx | P:D | fa_vattn_2mb | fa_paged_256 "
                "| ratio |", "|---|---|---|---|---|---|"]
        for (model, ctx, pd), per in mrows:
            v, p = per.get("fa_vattn_2mb"), per.get("fa_paged_256")
            if v and p:
                out.append(f"| {model} | {ctx // 1024}K | {pd} | {fmt(v)} "
                           f"| {fmt(p)} | {p / v:.2f}x |")

    if isinstance(data, dict) and data.get("decomposition"):
        out += ["", "Decomposition (makespan_s):"]
        out += [json.dumps(d) for d in data["decomposition"]]
    return out


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("path", nargs="?",
                   default="benchmark_output/longctx/grid_results.json")
    return add_device_arg(p)


def main(argv=None) -> list:
    args = parser().parse_args(argv)
    resolve(args.device)
    with open(args.path) as f:
        data = json.load(f)
    out = render(data)
    print("\n".join(out))
    return out


if __name__ == "__main__":
    main()
