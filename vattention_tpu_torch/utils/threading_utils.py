"""Threading decorators (ref: sarathi-lean/sarathi/utils/threading_utils.py:32)."""

from __future__ import annotations

import functools
import threading
import traceback


def synchronized(method):
    """Per-instance lock around a method (ref @synchronized)."""

    @functools.wraps(method)
    def wrapper(self, *args, **kwargs):
        lock = getattr(self, "_synchronized_lock", None)
        if lock is None:
            lock = threading.Lock()
            setattr(self, "_synchronized_lock", lock)
        with lock:
            return method(self, *args, **kwargs)

    return wrapper


def exit_on_error(fn):
    """Kill the process if a daemon thread dies (ref @exit_on_error)."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        try:
            return fn(*args, **kwargs)
        except Exception:  # noqa: BLE001
            traceback.print_exc()
            import os

            os._exit(1)

    return wrapper
