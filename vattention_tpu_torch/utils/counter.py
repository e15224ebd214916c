"""Counter + misc utils (ref: sarathi-lean/sarathi/utils/__init__.py)."""

from __future__ import annotations

import socket
from typing import Iterator


class Counter:
    def __init__(self, start: int = 0) -> None:
        self.counter = start

    def __next__(self) -> int:
        i = self.counter
        self.counter += 1
        return i

    def __iter__(self) -> Iterator[int]:
        return self

    def reset(self) -> None:
        self.counter = 0


def get_ip() -> str:
    return socket.gethostbyname(socket.gethostname())


def get_random_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("", 0))
        return s.getsockname()[1]
