"""The long-context static-trace A/B grid on one card.

Twin of ``scripts/run_longctx_grid.sh:52-192``: the same cells (``run_cfg``'s
arithmetic: ``decode = max(1, ctx // (pd + 1))``, ``prefill = ctx -
decode``, ``--max-model-len ctx + 128``), tags
(``{backend}[_fp8|_int8][_m{mistral|falcon}]_c{ctx}_pd{pd}``), engine flags
(zero weights, sarathi chunk 2048, ``--gpu-memory-utilization 0.93``, a
static trace of equal requests), per-cell output directory
``<out>/<tag>/summary.json`` and log ``<out>/<tag>.log``, and the same
groups, run in the same value order:

- ``pairs``: fa_vattn_2mb against fa_paged_256 at P:D 100, 32K (batch 8,
  8 requests), 64K (4, 6) and 128K (2, 4): the north star;
- ``extras32``: fa_vattn_256kb, fa_paged_16, and P:D 500 and 50 at 32K;
- ``pd64k``: P:D 500 and 50 at 64K;
- ``models``: mistral-7b-32k-l8 and falcon-7b-32k-l8 at 32K;
- ``fullextras``: fa_vattn_256kb at 64K and 128K, the fp8 and int8 pairs
  at 64K;
- ``pod``: fa_pod at 32K and 64K.

``--tier`` takes a comma-separated list of groups or an alias
(``headline`` = pairs,extras32; ``full``, the default, = every group;
``extras`` = every group but pairs).  The model is yi-6b-200k-l16 unless a
cell names another.  ``--test`` passes ``--test`` to every cell, which
``benchmark.main`` shrinks to the tiny model (2 requests of at most 256 +
8 tokens): the grid's path end to end, on the CPU with ``--device cpu``.

Each cell is its own process (``python -m
vattention_tpu_torch.benchmark.main``, a 2400 s limit), so a cell that
fails or runs out of memory cannot poison the next; a failed cell is
logged and the grid exits non-zero, naming it.  Differences from the
shell, none of which changes a cell's flags:

- the ``controls`` and ``tuned`` groups are refused: they set TPU tiling
  knobs (``PAGED_WIDE_TILE``, ``VATTN_WIDE_TILE``, ``VATTN_Q_TILE``) that
  the port does not have, since its kernels loop to the live depth;
- a failed cell is not retried: the shell's retry after 30 s waited for
  the TPU server to free the last cell's memory, which a finished
  process gives back here;
- each ``pod`` cell runs once: the shell's first, discarded run filled
  XLA's compilation cache, and the port's runner captures every step
  signature in its warm-up before the timed run.

Usage:
  python -m vattention_tpu_torch.scripts.longctx_grid --tier pairs
  python -m vattention_tpu_torch.scripts.collect_longctx_grid
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
from dataclasses import dataclass
from typing import List, Optional, Tuple

from vattention_tpu_torch.scripts.common import add_device_arg, resolve

MODEL = "yi-6b-200k-l16"
# short grid-model name -> (tag suffix, model)
MODELS = {"yi": ("", MODEL), "mistral": ("_mmistral", "mistral-7b-32k-l8"),
          "falcon": ("_mfalcon", "falcon-7b-32k-l8")}
# the groups in the order they run
GROUPS = ("pairs", "extras32", "pd64k", "models", "fullextras", "pod")
DROPPED = {
    "controls": "the wide-tile controls (PAGED_WIDE_TILE=512, "
                "VATTN_WIDE_TILE=256)",
    "tuned": "the tuned-tiling frontier (1024-wide kv and 256-row q tiles)",
}
ALIASES = {"headline": "pairs,extras32", "full": ",".join(GROUPS),
           "extras": ",".join(g for g in GROUPS if g != "pairs")}
CELL_TIMEOUT_S = 2400


@dataclass(frozen=True)
class Cell:
    """One ``run_cfg ctx backend pd batch nreq [kvq] none [model]``."""

    ctx: int
    backend: str
    pd: int
    batch: int
    nreq: int
    kvq: str = "none"
    mshort: str = "yi"

    @property
    def decode(self) -> int:
        return max(1, self.ctx // (self.pd + 1))

    @property
    def prefill(self) -> int:
        return self.ctx - self.decode

    @property
    def max_model_len(self) -> int:
        return self.ctx + 128

    @property
    def model(self) -> str:
        return MODELS[self.mshort][1]

    @property
    def tag(self) -> str:
        kv = "" if self.kvq == "none" else f"_{self.kvq}"
        return (f"{self.backend}{kv}{MODELS[self.mshort][0]}"
                f"_c{self.ctx}_pd{self.pd}")

    def argv(self, out_dir: str) -> List[str]:
        """``benchmark.main``'s flags, in the shell's order."""
        kv = [] if self.kvq == "none" else ["--kv-quant", self.kvq]
        return [
            "--model", self.model, "--load-format", "zero", *kv,
            "--attention-backend", self.backend,
            "--scheduler-type", "sarathi",
            "--chunk-size", "2048", "--max-model-len", str(self.max_model_len),
            "--max-batch-size", str(self.batch),
            "--max-num-seqs", str(self.batch),
            "--gpu-memory-utilization", "0.93",
            "--interval-generator", "static", "--length-generator", "fixed",
            "--num-requests", str(self.nreq),
            "--prefill-tokens", str(self.prefill),
            "--decode-tokens", str(self.decode),
            "--output-dir", os.path.join(out_dir, self.tag),
        ]


def cell_configs(cell: Cell, out_dir: str, device: str,
                 test: bool = False) -> Tuple[dict, dict]:
    """(engine kwargs, generator config) that ``benchmark.main`` builds
    from ``cell``'s flags: the cell in this process (chip_smoke (l))."""
    from vattention_tpu_torch.benchmark.main import (add_args,
                                                     configs_from_args)

    args = add_args(argparse.ArgumentParser()).parse_args(
        [*cell.argv(out_dir), *(["--test"] if test else []),
         "--device", device])
    return configs_from_args(args)


def group_cells(group: str) -> List[Cell]:
    """A group's cells in the shell's order."""
    pair = ("fa_vattn_2mb", "fa_paged_256")
    if group == "pairs":
        return [Cell(ctx, b, 100, batch, n)
                for ctx, batch, n in ((32768, 8, 8), (65536, 4, 6),
                                      (131072, 2, 4))
                for b in pair]
    if group == "extras32":
        return ([Cell(32768, "fa_vattn_256kb", 100, 8, 8),
                 Cell(32768, "fa_paged_16", 100, 8, 8)]
                + [Cell(32768, b, pd, 8, 8) for pd in (500, 50) for b in pair])
    if group == "pd64k":
        return [Cell(65536, b, pd, 4, 6) for pd in (500, 50) for b in pair]
    if group == "models":
        return [Cell(32768, b, 100, 8, 8, mshort=m)
                for m in ("mistral", "falcon") for b in pair]
    if group == "fullextras":
        return ([Cell(65536, "fa_vattn_256kb", 100, 4, 6),
                 Cell(131072, "fa_vattn_256kb", 100, 2, 4)]
                + [Cell(65536, b, 100, 4, 6, kvq=q)
                   for q in ("fp8", "int8") for b in pair])
    if group == "pod":
        return [Cell(ctx, "fa_pod", 100, batch, n)
                for ctx, batch, n in ((32768, 8, 8), (65536, 4, 6))]
    raise ValueError(f"unknown group {group!r}")


def parse_tier(tier: str) -> List[str]:
    """The groups ``tier`` selects, in the order they run; raises for an
    unknown group and for the groups the port dropped."""
    names = ALIASES.get(tier, tier).split(",")
    for g in names:
        if g in DROPPED:
            raise ValueError(
                f"grid group {g!r} sets TPU tiling knobs ({DROPPED[g]}) "
                "that the port dropped: its kernels loop to the live depth "
                "with no tile-width knobs (ROADMAP, deliberate divergences)")
        if g not in GROUPS:
            raise ValueError(f"unknown grid group {g!r}; groups: "
                             f"{', '.join(GROUPS)}; aliases: "
                             f"{', '.join(ALIASES)}")
    return [g for g in GROUPS if g in names]


def cells(tier: str) -> List[Cell]:
    return [c for g in parse_tier(tier) for c in group_cells(g)]


def tail(path: str, n: int = 6) -> str:
    with open(path, errors="replace") as f:
        return "".join(f.readlines()[-n:])


def run_cell(cell: Cell, out_dir: str, device: str, test: bool = False,
             timeout_s: float = CELL_TIMEOUT_S) -> Optional[str]:
    """Run one cell in a process of its own, its output in
    ``<out_dir>/<tag>.log``; None, or why it failed."""
    log = os.path.join(out_dir, f"{cell.tag}.log")
    cmd = [sys.executable, "-m", "vattention_tpu_torch.benchmark.main",
           *cell.argv(out_dir), *(["--test"] if test else []),
           "--device", device]
    print(f"=== {cell.tag} (B={cell.batch} n={cell.nreq}) ===", flush=True)
    with open(log, "w") as f:
        try:
            rc = subprocess.run(cmd, stdout=f, stderr=subprocess.STDOUT,
                                timeout=timeout_s).returncode
        except subprocess.TimeoutExpired:
            rc = f"timeout after {timeout_s} s"
    print(tail(log), end="", flush=True)
    if rc == 0:
        return None
    why = f"exit {rc}" if isinstance(rc, int) else rc
    print(f"  {cell.tag} failed ({why}; see {log})", flush=True)
    return why


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--tier", default="full",
                   help="comma-separated groups (" + ", ".join(GROUPS)
                        + ") or an alias (" + ", ".join(ALIASES) + ")")
    p.add_argument("--out", default="benchmark_output/longctx")
    p.add_argument("--test", action="store_true",
                   help="every cell shrunk by benchmark.main --test")
    return add_device_arg(p)


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    todo = cells(args.tier)
    resolve(args.device)
    os.makedirs(args.out, exist_ok=True)
    failed = {}
    for cell in todo:
        why = run_cell(cell, args.out, args.device, args.test)
        if why is not None:
            failed[cell.tag] = why
    if failed:
        print(f"grid done: {len(failed)} of {len(todo)} cells failed: "
              + ", ".join(f"{t} ({w})" for t, w in failed.items()))
        return 1
    print(f"grid done: {len(todo)} cells")
    return 0


if __name__ == "__main__":
    sys.exit(main())
