"""Seeded weights, made on the device, for the program and the reference.

Each tensor is drawn in one call, in the dtype it is served in, from a
``torch.Generator`` on the device seeded from the run's seed and the
tensor's name, so the same seed gives the same tensors on every call:
the harness draws them once into the program's parameters (in place,
before any graph is captured), and once more for the reference after
the program is gone.  Which tensors, their shapes and scales, and where
each sits in the program, are the model family's
(``families/<model_type>.py``: ``shapes`` and ``load_into_program``).
"""

from __future__ import annotations

import zlib
from typing import Iterator, Tuple

import torch


def score_std(config: dict) -> float:
    """The configuration's query-key score spread."""
    return float(config["weights"]["score_std"])


def draw(name: str, spec: tuple, seed: int, device,
         dtype=torch.bfloat16) -> torch.Tensor:
    """One tensor, (shape, kind, std) ``spec``, drawn in one call from its
    own generator."""
    shape, kind, std = spec
    gen = torch.Generator(device=device)
    gen.manual_seed((seed * 1_000_003 + zlib.crc32(name.encode()))
                    % (1 << 63))
    t = torch.empty(shape, dtype=dtype, device=device)
    t.normal_(1.0 if kind == "norm" else 0.0, std, generator=gen)
    return t


def all_weights(cell, seed: int, device,
                dtype=torch.bfloat16) -> Iterator[Tuple[str, torch.Tensor]]:
    """The cell's model's tensors for ``seed``, one at a time."""
    specs = cell.family().shapes(cell.dims, score_std(cell.config))
    for name, spec in specs.items():
        yield name, draw(name, spec, seed, device, dtype)


def load_into_program(cell, params: dict, seed: int) -> None:
    """Copy the seed's tensors into the program's parameters in place."""
    cell.family().load_into_program(
        params, cell.dims,
        lambda device, dtype: all_weights(cell, seed, device, dtype))
