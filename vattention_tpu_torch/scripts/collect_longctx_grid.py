"""Collect the long-context grid's cells into one JSON artifact.

Twin of ``scripts/collect_longctx_grid.py:21-162``: reads every
``<dir>/<tag>/summary.json`` (``longctx_grid``'s cells), parses the tag
(``{backend}[_fp8|_int8][_w512|_w256|_tuned][_m{model}]_c{ctx}_pd{pd}``;
the port's grid makes no wide-tile cells, but their tags still parse), and
writes ``{"configs", "vs_paged", "decomposition"}``:

- per cell, makespan_s, tokens_per_s, preemptions and the stall audit's
  ``stall_s`` over ``batch_execution_time.csv`` (the port's
  ``MetricsStore`` writes it with the JAX package's name and columns
  ``idx,batch_execution_time``): seconds spent in steps above max(5 x the
  median step, 0.5 s), so a makespan with nonzero stall_s is not a
  steady-state number;
- per non-paged cell, tokens/s and makespan against the plain
  fa_paged_256 twin of the same (ctx, P:D, model) and against the
  strongest (fastest) paged cell there;
- ``decomposition``: empty (see ``collect``).

``--archive [DIR]`` then does ``scripts/archive_grid_results.sh``'s copy:
each cell's summary.json into ``DIR/longctx/<tag>/``, the logs into
``DIR/longctx/`` and grid_results.json into ``DIR``
(default ``benchmark_output/port_archive``).  It refuses a directory under
the repository's ``data/``, which holds the JAX package's TPU results.  The
figure (``process_e2e_static --plot``) is left to a host with matplotlib.

Usage:
  python -m vattention_tpu_torch.scripts.collect_longctx_grid \\
      [--dir DIR] [--output F] [--archive [DIR]]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import shutil
from pathlib import Path

from vattention_tpu_torch.scripts.common import add_device_arg, resolve

ARCHIVE = "benchmark_output/port_archive"
DATA = Path(__file__).resolve().parents[2] / "data"


def parse_tag(tag):
    m = re.match(r"(.+)_c(\d+)_pd(\d+)(?:_fair)?$", tag)
    if not m:
        return None
    rest, ctx, pd = m.group(1), int(m.group(2)), int(m.group(3))
    model = "yi"
    wm = re.search(r"_m([a-z0-9-]+)$", rest)
    if wm:
        model, rest = wm.group(1), rest[: wm.start()]
    wide = None
    vm = re.search(r"_w(\d+)(q\d+)?$", rest)
    if vm:
        wide = (int(vm.group(1)) if not vm.group(2)
                else vm.group(0)[2:])  # e.g. "512q256"
        rest = rest[: vm.start()]
    elif rest.endswith("_tuned"):
        wide, rest = "tuned", rest[: -len("_tuned")]
    return {"backend": rest, "ctx": ctx, "pd_ratio": pd,
            "model": model, "wide_tile": wide}


def stall_s(path: str):
    """The stall audit of one cell's ``batch_execution_time.csv``, or None
    without steps."""
    with open(path) as f:
        ts = [float(line.split(",")[1])
              for line in f.readlines()[1:] if "," in line]
    if not ts:
        return None
    srt = sorted(ts)
    med = srt[len(srt) // 2]
    cut = max(5 * med, 0.5)
    return round(sum(t - cut for t in ts if t > cut), 2)


def collect(cell_dir: str) -> dict:
    rows = []
    for tag in sorted(os.listdir(cell_dir)):
        path = os.path.join(cell_dir, tag, "summary.json")
        if not os.path.exists(path):
            continue
        parsed = parse_tag(tag)
        if not parsed:
            continue
        with open(path) as f:
            s = json.load(f)
        parsed.update({
            "tag": tag,
            "makespan_s": s["totals"]["makespan_s"],
            "tokens_per_s": s["totals"]["tokens_per_s"],
            "preemptions": s["totals"]["preemptions"],
        })
        bx = os.path.join(cell_dir, tag, "batch_execution_time.csv")
        if os.path.exists(bx):
            stall = stall_s(bx)
            if stall is not None:
                parsed["stall_s"] = stall
        rows.append(parsed)

    def key(r):
        # wide_tile is None | int | "tuned": stringified for a stable sort
        return (r["backend"], r["ctx"], r["pd_ratio"], r["model"],
                str(r["wide_tile"]))

    # each cell against the plain fa_paged_256 twin and the strongest
    # paged cell of the same (ctx, pd, model)
    ratios = []
    for r in sorted(rows, key=key):
        if r["backend"].startswith("fa_paged") or r["backend"].startswith(
                "fi_paged"):
            continue
        cand = [p for p in rows
                if p["backend"] == "fa_paged_256"
                and (p["ctx"], p["pd_ratio"], p["model"]) ==
                    (r["ctx"], r["pd_ratio"], r["model"])]
        if not cand:
            continue
        plain = next((p for p in cand if p["wide_tile"] is None), None)
        strongest = min(cand, key=lambda p: p["makespan_s"])
        entry = {
            "backend": r["backend"], "ctx": r["ctx"],
            "pd_ratio": r["pd_ratio"], "model": r["model"],
            "wide_tile": r["wide_tile"],
            "strongest_paged_tag": strongest["tag"],
            "tokens_ratio_vs_strongest_paged":
                round(r["tokens_per_s"] / strongest["tokens_per_s"], 4),
            "makespan_ratio_strongest_paged_over_this":
                round(strongest["makespan_s"] / r["makespan_s"], 4),
        }
        if plain is not None:
            entry["tokens_ratio_vs_paged"] = round(
                r["tokens_per_s"] / plain["tokens_per_s"], 4)
            entry["makespan_ratio_paged_over_this"] = round(
                plain["makespan_s"] / r["makespan_s"], 4)
        ratios.append(entry)

    # The JAX collector's tile-width decomposition looks its four control
    # cells up by (..., None | int) in a table keyed by (..., str(wide)), so
    # it finds none and is always empty; the port's grid makes no control
    # cells.  The key stays, empty, for the JSON's readers.
    return {"configs": rows, "vs_paged": ratios, "decomposition": []}


def archive(cell_dir: str, grid_json: str, dst: str) -> int:
    """``archive_grid_results.sh``'s copy into ``dst``; the cells
    archived."""
    root = Path(dst).resolve()
    if root == DATA or DATA in root.parents:
        raise ValueError(f"--archive {dst}: the repository's data/ holds the "
                         "JAX package's TPU results; archive elsewhere")
    cells = root / "longctx"
    cells.mkdir(parents=True, exist_ok=True)
    n = 0
    for summary in sorted(glob.glob(os.path.join(cell_dir, "*",
                                                 "summary.json"))):
        tag_dir = cells / os.path.basename(os.path.dirname(summary))
        tag_dir.mkdir(exist_ok=True)
        shutil.copy(summary, tag_dir)
        n += 1
    for log in glob.glob(os.path.join(cell_dir, "*.log")):
        shutil.copy(log, cells)
    shutil.copy(grid_json, root / "grid_results.json")
    print(f"archived {n} cells -> {cells}")
    return n


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--dir", default="benchmark_output/longctx")
    p.add_argument("--output",
                   default="benchmark_output/longctx/grid_results.json")
    p.add_argument("--archive", nargs="?", const=ARCHIVE, default=None,
                   help=f"copy the results into this directory ({ARCHIVE} "
                        "if none is given)")
    return add_device_arg(p)


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    resolve(args.device)
    out = collect(args.dir)
    os.makedirs(os.path.dirname(args.output) or ".", exist_ok=True)
    with open(args.output, "w") as f:
        json.dump(out, f, indent=2)
    for r in out["vs_paged"]:
        print(r)
    print(f"wrote {args.output}")
    if args.archive is not None:
        archive(args.dir, args.output, args.archive)
    return out


if __name__ == "__main__":
    main()
