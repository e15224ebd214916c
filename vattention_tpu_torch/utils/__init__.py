"""Utilities (ref: sarathi-lean/sarathi/utils/)."""

from vattention_tpu_torch.utils.counter import Counter, get_ip, get_random_port
from vattention_tpu_torch.utils.threading_utils import exit_on_error, synchronized

__all__ = ["Counter", "get_ip", "get_random_port", "synchronized",
           "exit_on_error"]
