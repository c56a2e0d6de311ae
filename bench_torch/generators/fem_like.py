"""FEM stiffness-like matrix: dense dofs x dofs blocks on a banded node graph.

A copy of ``sextans_tpu_torch/utils/matrices.py:fem_like`` (itself a copy of
``benchmarks/matrices.py:fem_like``) as of the benchmark's first version;
``selftest.py`` holds the two to the same COO at every configured argument.
"""

from __future__ import annotations

import numpy as np

from bench_torch.pattern import Pattern

# the program's function this copies (selftest: the same COO at every configured argument)
PORT_TWIN = "sextans_tpu_torch.utils.matrices:fem_like"


def generate(m: int, dofs: int = 3, neighbors: int = 9, bandwidth: int = 400,
             seed: int = 0) -> Pattern:
    """Each of ``m // dofs`` nodes couples to ``neighbors`` nearby nodes
    (within ``bandwidth`` rows), every coupling a dense dofs x dofs block;
    duplicates dropped, values standard normal (zeros made 1)."""
    rng = np.random.default_rng(seed)
    nodes = m // dofs
    src = np.repeat(np.arange(nodes), neighbors)
    off = rng.integers(-bandwidth // dofs, bandwidth // dofs + 1, size=src.size)
    dst = np.clip(src + off, 0, nodes - 1)
    di, dj = np.meshgrid(np.arange(dofs), np.arange(dofs), indexing="ij")
    rows = (src[:, None, None] * dofs + di[None]).reshape(-1)
    cols = (dst[:, None, None] * dofs + dj[None]).reshape(-1)
    lin = rows.astype(np.int64) * m + cols
    _, keep = np.unique(lin, return_index=True)
    rows, cols = rows[keep], cols[keep]
    vals = rng.standard_normal(rows.size).astype(np.float32)
    vals[vals == 0] = 1.0
    return Pattern((m, m), rows.astype(np.int32), cols.astype(np.int32), vals)
