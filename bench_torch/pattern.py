"""The benchmark's own sparse matrix: a shape and COO arrays on the host."""

from __future__ import annotations

import importlib
from typing import NamedTuple, Tuple

import numpy as np


class Pattern(NamedTuple):
    """A sparse matrix as COO triples: int32 rows and cols, f32 vals."""

    shape: Tuple[int, int]
    rows: np.ndarray
    cols: np.ndarray
    vals: np.ndarray

    @property
    def nnz(self) -> int:
        return int(self.rows.size)


def make_pattern(spec: dict) -> Pattern:
    """The matrix of a configuration's ``matrix`` entry:
    ``generators/<generator>.py``'s ``generate(**args)``."""
    module = importlib.import_module(f"bench_torch.generators.{spec['generator']}")
    return module.generate(**spec["args"])
