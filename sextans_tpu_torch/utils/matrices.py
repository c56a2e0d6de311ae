"""Synthetic test matrices, without the JAX package.

``fem_like``, ``circuit_like`` and ``stencil_3d`` are ``benchmarks/matrices.py``'s
generators, carried over so that ``chip_smoke.py`` can build ``cant_like``
(``fem_like(62451, dofs=3, neighbors=21, seed=2)``), ``scircuit_like``
(``circuit_like(170998, seed=9)``) and ``laplace3d_64`` (``stencil_3d(64,
seed=12)``) on a machine without JAX.
"""

from __future__ import annotations

import numpy as np

from sextans_tpu_torch.format.coo import COOMatrix

__all__ = ["fem_like", "circuit_like", "stencil_3d"]


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


def circuit_like(
    m: int, extra_per_row: int = 4, hubs: int = 40, seed: int = 0
) -> COOMatrix:
    """scircuit-class: sparse diagonal-dominant netlist with a few dense
    power/ground "rail" columns and rows (the hub nets)."""
    rng = np.random.default_rng(seed)
    diag = np.arange(m, dtype=np.int64)
    # local couplings, mostly near-diagonal
    nloc = m * extra_per_row
    lr = rng.integers(0, m, size=nloc)
    lc = np.clip(lr + rng.integers(-60, 61, size=nloc), 0, m - 1)
    # hub nets: a handful of columns (and rows) touched by ~0.5% of nodes each
    hub_ids = rng.integers(0, m, size=hubs)
    per_hub = max(1, m // 200)
    hr = rng.integers(0, m, size=hubs * per_hub)
    hc = np.repeat(hub_ids, per_hub)
    rows = np.concatenate([diag, lr, hr, hc])
    cols = np.concatenate([diag, lc, hc, hr])
    lin = rows * m + cols
    _, keep = np.unique(lin, return_index=True)
    vals = rng.standard_normal(keep.size).astype(np.float32)
    vals[vals == 0] = 1.0
    return COOMatrix(
        (m, m), rows[keep].astype(np.int32), cols[keep].astype(np.int32), vals
    )


def stencil_3d(side: int, seed: int = 0) -> COOMatrix:
    """Graph-Laplacian class: 7-point stencil on a 3-D grid."""
    m = side ** 3
    diag = np.arange(m, dtype=np.int64)
    rows, cols = [diag], [diag]
    for off in (-1, 1, -side, side, -side * side, side * side):
        d = diag + off
        ok = (d >= 0) & (d < m)
        rows.append(diag[ok])
        cols.append(d[ok])
    rows = np.concatenate(rows)
    cols = np.concatenate(cols)
    rng = np.random.default_rng(seed)
    vals = rng.standard_normal(rows.size).astype(np.float32)
    vals[vals == 0] = 1.0
    return COOMatrix(
        (m, m), rows.astype(np.int32), cols.astype(np.int32), vals
    )
