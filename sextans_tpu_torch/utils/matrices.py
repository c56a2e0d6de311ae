"""Synthetic test matrices, without the JAX package.

``fem_like`` is ``benchmarks/matrices.py``'s generator, carried over so that
``chip_smoke.py`` can build ``cant_like`` (``fem_like(62451, dofs=3,
neighbors=21, seed=2)``) on a machine without JAX.
"""

from __future__ import annotations

import numpy as np

from sextans_tpu_torch.format.coo import COOMatrix

__all__ = ["fem_like"]


def fem_like(
    m: int, dofs: int = 3, neighbors: int = 9, bandwidth: int = 400, seed: int = 0
) -> COOMatrix:
    """FEM stiffness-like: dense dofs x dofs blocks, banded node graph.

    Structural stand-in for cant / consph / pdb1HYS / shipsec1 / ldoor:
    each node couples to ~``neighbors`` nearby nodes, every coupling is a
    dense dofs x dofs block → high 8xBK block fill, banded.
    """
    rng = np.random.default_rng(seed)
    nodes = m // dofs
    src = np.repeat(np.arange(nodes), neighbors)
    off = rng.integers(-bandwidth // dofs, bandwidth // dofs + 1, size=src.size)
    dst = np.clip(src + off, 0, nodes - 1)
    # expand each node pair into a dense dofs x dofs block
    di, dj = np.meshgrid(np.arange(dofs), np.arange(dofs), indexing="ij")
    rows = (src[:, None, None] * dofs + di[None]).reshape(-1)
    cols = (dst[:, None, None] * dofs + dj[None]).reshape(-1)
    lin = rows.astype(np.int64) * m + cols
    _, keep = np.unique(lin, return_index=True)
    rows, cols = rows[keep], cols[keep]
    vals = rng.standard_normal(rows.size).astype(np.float32)
    vals[vals == 0] = 1.0
    return COOMatrix((m, m), rows.astype(np.int32), cols.astype(np.int32), vals)
