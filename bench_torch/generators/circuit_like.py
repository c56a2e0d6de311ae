"""Circuit-netlist-like matrix: a near-diagonal band with a few dense hub
columns and rows (power and ground rails), scircuit's class.

A copy of ``sextans_tpu_torch/utils/matrices.py:circuit_like`` (itself a copy
of ``benchmarks/matrices.py:circuit_like``) as of this generator's first
version; ``selftest.py`` holds the two to the same COO at every configured
argument.
"""

from __future__ import annotations

import numpy as np

from bench_torch.pattern import Pattern

# the program's function this copies (selftest: the same COO at every configured argument)
PORT_TWIN = "sextans_tpu_torch.utils.matrices:circuit_like"


def generate(m: int, extra_per_row: int = 4, hubs: int = 40, seed: int = 0) -> Pattern:
    """The diagonal, ``extra_per_row`` couplings a row within 60 of the
    diagonal, and ``hubs`` hub nets, each a column and a row touched by
    ``m // 200`` random rows; duplicates dropped, values standard normal
    (zeros made 1)."""
    rng = np.random.default_rng(seed)
    diag = np.arange(m, dtype=np.int64)
    nloc = m * extra_per_row
    lr = rng.integers(0, m, size=nloc)
    lc = np.clip(lr + rng.integers(-60, 61, size=nloc), 0, m - 1)
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
    return Pattern((m, m), rows[keep].astype(np.int32), cols[keep].astype(np.int32), vals)
