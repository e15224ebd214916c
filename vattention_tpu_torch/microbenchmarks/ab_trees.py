"""Run ``chip_smoke.py`` of two checkouts in turns on one card and set
their numbers side by side.

    python3 -m vattention_tpu_torch.microbenchmarks.ab_trees \\
        --parent build/parent --change build/change --rounds 3 \\
        --out build/ab

Each round runs three passes of ``python3 chip_smoke.py``, each in its
own checkout: the parent's; the change's under ``VATTN_TIMER=enqueue``
(``timing.py``: the L2 flush alone before each call, so a call's host
time past the flush counts, the parent's yardstick where it lacks the
device-side wait); and the change's with its own timer.  Every other
round runs them in reverse order (parent, change-enqueue, change; then
change, change-enqueue, parent; ...), so a drift of the machine over the
call falls on both sides.  Each pass's output goes to
``<out>/<label>_<round>.txt``.

The summary, printed and written to ``<out>/summary.json``, lists for
every pass: phase (a)'s kernel and library times, F beside B then C and
F's roles alone, the serving walls of (c), (d) and (e), the wall and
device-busy time of their profiled windows, and bench_pod's serial and
fused times per layer call; then each metric's mean per label.  Numbers
are copied as the passes printed them.  Exits non-zero if a pass fails.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

LABELS = ("parent", "change-enqueue", "change")

# "(a) <name>...: ... ms X ... library Y" and F's "B then C serially Z"
A_LINE = re.compile(r"^\(a\) (\w+)")
A_QUAL = re.compile(r"\d+-token blocks|\d+ extents|sub=16")
A_NUMS = {"ms": re.compile(r"\bms ([0-9.]+)"),
          "library": re.compile(r"library ([0-9.]+)"),
          "B then C": re.compile(r"B then C serially ([0-9.]+)")}
ROLES = re.compile(r"^\(a\) pod_attention by role: prefill role alone .*? "
                   r"([0-9.]+) ms, B ([0-9.]+) ms; decode role alone .*? "
                   r"([0-9.]+) ms, C ([0-9.]+) ms")
WALL = re.compile(r"^\((c|d|e)\) \S+: served .* wall ([0-9.]+) s")
PROFILE = re.compile(r"^\(p (c|d|e)\) profiled .* wall ([0-9.]+) ms, "
                     r"device busy ([0-9.]+) ms")
POD = re.compile(r"^\s*(serial|pod_fused):\s+([0-9.]+) us")


def parse(text: str) -> dict:
    """Metric name -> the number one chip_smoke pass printed for it."""
    out = {}
    for line in text.splitlines():
        m = ROLES.match(line)
        if m:
            for key, v in zip(("F prefill role alone", "B beside it",
                               "F decode role alone", "C beside it"),
                              m.groups()):
                out[f"(a) {key} ms"] = float(v)
            continue
        m = A_LINE.match(line)
        if m and " ms " in line and ("library" in line or "serially" in line):
            qual = A_QUAL.search(line)
            qual = qual.group(0) if qual else ""
            if "chunk 2048" in line:   # the body at depth, before 512@4096
                qual = "chunk 2048 at 32K"
            name = m.group(1) + (f" [{qual}]" if qual else "")
            for key, rx in A_NUMS.items():
                v = rx.search(line)
                if v:
                    out[f"(a) {name} {key}"] = float(v.group(1))
            continue
        m = WALL.match(line)
        if m:
            out[f"({m.group(1)}) wall s"] = float(m.group(2))
            continue
        m = PROFILE.match(line)
        if m:
            out[f"(p {m.group(1)}) wall ms"] = float(m.group(2))
            out[f"(p {m.group(1)}) device busy ms"] = float(m.group(3))
            continue
        m = POD.match(line)
        if m:
            out[f"(f) bench_pod {m.group(1)} us"] = float(m.group(2))
    return out


def run_pass(tree: Path, label: str, rnd: int, out_dir: Path,
             timeout: float) -> dict:
    env = dict(os.environ)
    env.pop("VATTN_TIMER", None)
    if label == "change-enqueue":
        env["VATTN_TIMER"] = "enqueue"
    log_path = out_dir / f"{label}_{rnd}.txt"
    t0 = time.perf_counter()
    with open(log_path, "w") as f:
        proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tree,
                              env=env, stdout=f, stderr=subprocess.STDOUT,
                              timeout=timeout)
    text = log_path.read_text()
    last = text.strip().splitlines()[-1] if text.strip() else ""
    ok = proc.returncode == 0 and '"ok": true' in last
    print(f"{label} round {rnd}: rc {proc.returncode}, "
          f"{time.perf_counter() - t0:.1f} s, {'ok' if ok else 'FAILED'}",
          flush=True)
    return {"label": label, "round": rnd, "ok": ok, **parse(text)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--change", type=Path, required=True)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", type=Path, default=Path("build/ab"))
    ap.add_argument("--timeout", type=float, default=1200.0,
                    help="seconds for one pass")
    args = ap.parse_args(argv)
    args.out.mkdir(parents=True, exist_ok=True)
    trees = {"parent": args.parent, "change-enqueue": args.change,
             "change": args.change}
    runs = []
    for rnd in range(args.rounds):
        order = LABELS if rnd % 2 == 0 else LABELS[::-1]
        for label in order:
            runs.append(run_pass(trees[label].resolve(), label, rnd, args.out,
                                 args.timeout))
    metrics = sorted({k for r in runs for k in r} - {"label", "round", "ok"})
    cols = [f"{r['label']}/{r['round']}" for r in runs]
    print("metric | " + " | ".join(cols) + " | "
          + " | ".join(f"mean {lb}" for lb in LABELS))
    means = {}
    for k in metrics:
        row = [str(r.get(k, "-")) for r in runs]
        for lb in LABELS:
            vals = [r[k] for r in runs if r["label"] == lb and k in r]
            means[(k, lb)] = sum(vals) / len(vals) if vals else None
        print(f"{k} | " + " | ".join(row) + " | " + " | ".join(
            "-" if means[(k, lb)] is None else repr(means[(k, lb)])
            for lb in LABELS))
    (args.out / "summary.json").write_text(json.dumps(
        {"runs": runs, "means": {f"{k} | {lb}": v
                                 for (k, lb), v in means.items()}},
        indent=1))
    return 0 if all(r["ok"] for r in runs) else 1


if __name__ == "__main__":
    sys.exit(main())
