"""Inputs drawn from ``--seed``: the same seed gives the same tensors.

Each input is its own stream, seeded from the run's seed and the stream's
name, and drawn on the device in one call by a ``torch.Generator`` there.
The program is given these tensors (or host copies of them); the reference
draws them again after the window, so it takes nothing the program made.
"""

from __future__ import annotations

import zlib

import torch


def stream_seed(seed: int, stream: str) -> int:
    """A generator seed for ``stream`` under the run's ``seed`` (any whole
    number, negative or past 64 bits included)."""
    return (int(seed) * 0x9E3779B97F4A7C15 + zlib.crc32(stream.encode())) % (1 << 63)


def normal(seed: int, stream: str, shape, device) -> torch.Tensor:
    """Standard normal f32 of ``shape`` on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, stream))
    return torch.randn(shape, generator=gen, device=device, dtype=torch.float32)


def nonzero_normal(seed: int, stream: str, shape, device) -> torch.Tensor:
    """:func:`normal` with exact zeros made 1, so that every entry of a
    matrix's pattern holds a value (as the generators make them)."""
    x = normal(seed, stream, shape, device)
    return torch.where(x == 0, torch.ones_like(x), x)
