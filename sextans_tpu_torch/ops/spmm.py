"""Top-level SpMM API: C = alpha * A @ B + beta * C.

The PyTorch counterpart of ``sextans_tpu.ops.spmm``: ``prepare`` packs any
supported sparse container, ``plan`` caches a device-resident
:class:`~sextans_tpu_torch.ops.plan.SpmmPlan` on the pack, and ``spmm`` runs
one product. Backends are those of ``SpmmPlan``.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from sextans_tpu_torch.format.coo import COOMatrix
from sextans_tpu_torch.format.csr import CSCMatrix, CSRMatrix
from sextans_tpu_torch.format.pack import PackedSpMatrix, pack
from sextans_tpu_torch.format.pack_edge import PackedSpMatrixEdge
from sextans_tpu_torch.format.pack_ell import PackedSpMatrixELL
from sextans_tpu_torch.format.pack_mxu import PackedSpMatrixMXU
from sextans_tpu_torch.ops.plan import PACKS, SpmmPlan, resolve_device
from sextans_tpu_torch.utils.config import SpmmConfig

__all__ = ["spmm", "prepare", "plan"]
MatrixLike = Union[
    PackedSpMatrix, PackedSpMatrixMXU, PackedSpMatrixEdge, PackedSpMatrixELL,
    COOMatrix, CSRMatrix, CSCMatrix,
]


def prepare(a, config: Optional[SpmmConfig] = None):
    """Coerce any supported sparse container into a packed matrix.

    A pack (block, slab, edge or ELL format) is returned as it is; COO, CSR,
    CSC, any ``scipy.sparse`` matrix and dense 2-D NumPy arrays or tensors
    (exact zeros dropped) are packed into the block format with ``config``.
    """
    if isinstance(a, PACKS):
        return a
    cfg = config or SpmmConfig()
    if isinstance(a, (CSRMatrix, CSCMatrix)):
        a = a.to_coo()
    if not isinstance(a, COOMatrix):
        if hasattr(a, "tocoo"):  # any scipy.sparse format
            a = COOMatrix.from_scipy(a)
        elif isinstance(a, torch.Tensor) and a.dim() == 2 and a.layout == torch.strided:
            a = COOMatrix.from_dense(a.detach().cpu().numpy())
        elif isinstance(a, np.ndarray) and a.ndim == 2:
            a = COOMatrix.from_dense(a)
        else:
            raise TypeError(f"unsupported sparse matrix type {type(a)!r}")
    return pack(a, cfg)


def plan(packed, n: int, backend: str = "auto", *, device) -> SpmmPlan:
    """Get (and cache on the packed matrix) a device-resident SpmmPlan."""
    cache = packed.__dict__.setdefault("_plan_cache", {})
    key = (n, backend, str(resolve_device(device)))
    if key not in cache:
        cache[key] = SpmmPlan(packed, n, backend=backend, device=device)
    return cache[key]


def spmm(
    a: MatrixLike,
    b,
    alpha: float = 1.0,
    beta: float = 0.0,
    c=None,
    *,
    backend: str = "auto",
    config: Optional[SpmmConfig] = None,
    device=None,
) -> torch.Tensor:
    """Sparse-matrix x dense-matrix product with the reference semantics.

    ``a``: sparse (M, K) in any supported container (pack it once and pass
    the pack when calling repeatedly). ``b``: dense (K, N). ``c``: dense
    (M, N), required when ``beta != 0``. ``device``: where to run; by default
    the device of ``b`` when it is a tensor, else ``cuda``. The CPU runs only
    when asked for, with ``device="cpu"`` or a CPU tensor ``b``.
    """
    packed = prepare(a, config)
    if device is None:
        device = b.device if isinstance(b, torch.Tensor) else "cuda"
    if not isinstance(b, torch.Tensor):
        b = np.asarray(b, dtype=np.float32)
    k = packed.shape[1]
    if b.ndim != 2 or b.shape[0] != k:
        raise ValueError(f"B must be ({k}, N) dense, got {tuple(b.shape)}")
    return plan(packed, b.shape[1], backend=backend, device=device)(b, alpha, beta, c)
