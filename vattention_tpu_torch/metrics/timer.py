"""Host spans and profiler sessions (counterpart of
vattention_tpu/metrics/timer.py).

  - span: a named host phase of the component that owns ``store`` (each
    replica's engine, worker and runner share one store).  Its duration
    always lands in the store's host-phase sketch of its name, where it
    has one (``SKETCHES``).  While a ``torch.profiler`` session is
    recording, or the store's ``enable_chrome_trace`` is set, it is also
    recorded: the store keeps
    ``SpanRecord(name, start_ns, end_ns, parent, step, counts)`` on
    ``time.monotonic_ns()`` (the clock of the sequence state's stamps),
    and a profiler range of the same name puts it in the profiler's trace
    beside the kernels it launched.  The range is ``record_function``'s
    cheap form, ``_RecordFunctionFast`` (an op range, ~1 µs a span on the
    CPU against ~10 for ``record_function``'s annotation).  Not
    recording, a span costs one boolean check beyond the stamps.
  - profile_session: ``torch.profiler`` around a block, written out as a
    chrome trace.

Span names start with ``vattn.``; every span opened inside ``vattn.step``
carries that step's id.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch
from torch._C._profiler import _RecordFunctionFast

from vattention_tpu_torch.metrics.constants import CpuOperationMetrics
from vattention_tpu_torch.metrics.metrics_store import MetricsStore

STEP = "vattn.step"
SCHEDULE = "vattn.schedule"
KV_STEP = "vattn.kv_step"
PREPARE = "vattn.prepare"
LAUNCH = "vattn.launch"
RESOLVE_WAIT = "vattn.resolve_wait"
OUTPUTS = "vattn.outputs"
REQUEST_PREFILL = MetricsStore.REQUEST_PREFILL
NAMES = (STEP, SCHEDULE, KV_STEP, PREPARE, LAUNCH, RESOLVE_WAIT, OUTPUTS,
         REQUEST_PREFILL)

# the host-phase sketch each span feeds
SKETCHES = {
    SCHEDULE: CpuOperationMetrics.SCHEDULE.value,
    KV_STEP: CpuOperationMetrics.KV_STEP.value,
    PREPARE: CpuOperationMetrics.PREPARE_INPUTS.value,
    OUTPUTS: CpuOperationMetrics.PROCESS_MODEL_OUTPUTS.value,
}


class span:
    """``with span(store, name, **counts) as s:`` around a host phase;
    while ``s.recording``, ``s.counts`` may take more counts before the
    block ends."""

    __slots__ = ("name", "counts", "recording", "_store", "_t0", "_range",
                 "_parent", "step")

    def __init__(self, store: MetricsStore, name: str, **counts):
        self._store = store
        self.name = name
        self.counts = counts

    def __enter__(self) -> "span":
        store = self._store
        self.recording = store.recording()
        if self.recording:
            self._open(store)
        self._t0 = time.monotonic_ns()
        return self

    def _open(self, store: MetricsStore) -> None:
        stack = store.open_spans
        parent = stack[-1] if stack else None
        self._parent = parent.name if parent is not None else None
        if self.name == STEP:
            self.step = store.new_step_id()
            self.counts["step"] = self.step
        else:
            self.step = parent.step if parent is not None else None
        stack.append(self)
        self._range = _RecordFunctionFast(self.name)
        self._range.__enter__()

    def __exit__(self, *exc) -> bool:
        t1 = time.monotonic_ns()
        sketch = SKETCHES.get(self.name)
        if sketch is not None:
            self._store.push_cpu_operation_time(sketch,
                                                (t1 - self._t0) / 1e9)
        if self.recording:
            self._range.__exit__(*exc)
            self._store.open_spans.pop()
            self._store.record_span(self.name, self._t0, t1, self._parent,
                                    self.step, self.counts)
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
