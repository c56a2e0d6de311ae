"""Random matrix with unique coordinates, optionally banded.

A copy of ``sextans_tpu_torch/format/coo.py:COOMatrix.random`` as of the
benchmark's first version (``bench.py``'s stand-in for nasa4704 calls it with
``banded=True``); ``selftest.py`` holds the two to the same COO at every
configured argument.
"""

from __future__ import annotations

import numpy as np

from bench_torch.pattern import Pattern

# the program's function this copies (selftest: the same COO at every configured argument)
PORT_TWIN = "sextans_tpu_torch.format.coo:COOMatrix.random"


def generate(m: int, k: int, nnz: int, seed: int = 0, banded: bool = False,
             bandwidth: int = 64) -> Pattern:
    """Up to ``nnz`` unique coordinates drawn from ``2 * nnz`` candidates
    (within ``bandwidth`` of the diagonal if ``banded``), values standard
    normal (zeros made 1)."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, m, size=2 * nnz)
    if banded:
        offs = rng.integers(-bandwidth, bandwidth + 1, size=2 * nnz)
        cols = np.clip(rows + offs, 0, k - 1)
    else:
        cols = rng.integers(0, k, size=2 * nnz)
    lin = rows.astype(np.int64) * k + cols
    _, first = np.unique(lin, return_index=True)
    first = first[:nnz]
    rows, cols = rows[first], cols[first]
    vals = rng.standard_normal(len(rows)).astype(np.float32)
    vals[vals == 0] = 1.0
    return Pattern((m, k), rows.astype(np.int32), cols.astype(np.int32), vals)
