"""What the experiment scripts share: the ``--device`` flag and a clock
for device work."""

from __future__ import annotations

import argparse
import time

import torch

# the device ``--device`` names; raises for ``cuda`` without a GPU, never
# falling back to the CPU
from vattention_tpu_torch.engine.base_llm_engine import (  # noqa: F401
    resolve_device as resolve)


def add_device_arg(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu; without a GPU the "
                        "script raises unless given cpu")
    return p


class Clock:
    """Marks on the device's stream: CUDA events on the card (a span ends
    when the device has run the work enqueued before its end mark), the
    host clock on the CPU, where work runs as it is enqueued."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def mark(self):
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def seconds(self, start, end) -> float:
        """Seconds from ``start`` to ``end``, after waiting for ``end``."""
        if not self.cuda:
            return end - start
        end.synchronize()
        return start.elapsed_time(end) / 1e3
