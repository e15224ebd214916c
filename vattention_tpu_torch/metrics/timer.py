"""Timers (counterpart of vattention_tpu/metrics/timer.py).

  - CpuTimer: wall-clock context manager for host phases (scheduling,
    prepare_inputs, allocator step) feeding the MetricsStore.
  - DeviceTimer: a ``torch.profiler.record_function`` range, so the ops
    inside it appear under ``name`` in profiler traces; with ``sync=True``
    it also times the block with CUDA events and waits for the second one
    (for debugging only: the wait stops the host from running ahead of
    the device, which async serving relies on).
  - profile_session: ``torch.profiler`` around a block, written out as a
    chrome trace.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch

from vattention_tpu_torch.metrics.metrics_store import CDFSketch


class CpuTimer:
    def __init__(self, sketch: Optional[CDFSketch] = None,
                 name: str = ""):
        self.sketch = sketch
        self.name = name
        self.last = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.last = time.perf_counter() - self._t0
        if self.sketch is not None:
            self.sketch.add(self.last)
        return False


class DeviceTimer:
    """Named profiler range; with ``sync`` (a CUDA device needed) the
    block's device seconds on the current stream land in ``last`` (and
    ``sketch``)."""

    def __init__(self, name: str, sync: bool = False,
                 sketch: Optional[CDFSketch] = None):
        self.name = name
        self.sync = sync
        self.sketch = sketch
        self.last = None

    def __enter__(self):
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        if self.sync:
            self._start = torch.cuda.Event(enable_timing=True)
            self._end = torch.cuda.Event(enable_timing=True)
            self._start.record()
        return self

    def __exit__(self, *exc):
        if self.sync:
            self._end.record()
            self._end.synchronize()
            self.last = self._start.elapsed_time(self._end) / 1e3
            if self.sketch is not None:
                self.sketch.add(self.last)
        self._range.__exit__(*exc)
        return False


@contextlib.contextmanager
def profile_session(log_dir: str, cuda: Optional[bool] = None):
    """``torch.profiler`` around the block (the device's activity too when
    ``cuda``, by default when a CUDA device is present); the trace goes to
    ``<log_dir>/trace.json``.  Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    if cuda is None:
        cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
