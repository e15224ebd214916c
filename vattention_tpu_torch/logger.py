"""Logging for vattention_tpu_torch (ref: sarathi-lean/sarathi/logger.py)."""

import logging
import sys

_FORMAT = "%(levelname)s %(asctime)s %(name)s:%(lineno)d] %(message)s"
_DATE_FORMAT = "%m-%d %H:%M:%S"

_root_configured = False


def _configure_root() -> None:
    global _root_configured
    if _root_configured:
        return
    handler = logging.StreamHandler(sys.stdout)
    handler.setFormatter(logging.Formatter(_FORMAT, datefmt=_DATE_FORMAT))
    root = logging.getLogger("vattention_tpu_torch")
    root.setLevel(logging.INFO)
    root.addHandler(handler)
    root.propagate = False
    _root_configured = True


def init_logger(name: str) -> logging.Logger:
    _configure_root()
    if not name.startswith("vattention_tpu_torch"):
        name = "vattention_tpu_torch." + name
    return logging.getLogger(name)
