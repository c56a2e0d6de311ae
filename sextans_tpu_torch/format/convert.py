"""Carry a packed matrix or a hybrid split across from the JAX package.

A ``sextans_tpu`` pack (block, slab, edge or ELL format) or ``HybridSplit``
holds NumPy arrays and plain fields only, so it converts without importing
``sextans_tpu``: fields are read by name. Tests use this to feed the same
packed A, or the same split, to both packages.
"""

from __future__ import annotations

from dataclasses import fields
from typing import Union

import numpy as np

from sextans_tpu_torch.format.pack import PackedSpMatrix, PackStats
from sextans_tpu_torch.format.pack_edge import PackedSpMatrixEdge
from sextans_tpu_torch.format.pack_ell import PackedSpMatrixELL
from sextans_tpu_torch.format.coo import COOMatrix
from sextans_tpu_torch.format.pack_mxu import PackedSpMatrixMXU
from sextans_tpu_torch.ops.hybrid import HybridSplit
from sextans_tpu_torch.utils.config import SpmmConfig

__all__ = ["from_reference"]

# format -> (class, its arrays with their dtypes, its scalar fields)
_FORMATS = {
    "qm": (PackedSpMatrixMXU, (("vals", np.float32), ("qm", np.int32),
                               ("bcol", np.int32), ("group_mtile", np.int32),
                               ("group_kwin", np.int32)),
           ("n_mtiles", "n_kwins")),
    "qrow": (PackedSpMatrix, (("vals", np.float32), ("qrow", np.int32),
                              ("bcol", np.int32), ("group_mtile", np.int32),
                              ("group_kwin", np.int32)),
             ("n_mtiles", "n_kwins")),
    "meta": (PackedSpMatrixEdge, (("vals", np.float32), ("meta", np.int32),
                                  ("chunk_mtile", np.int32),
                                  ("chunk_kwin", np.int32)),
             ("n_mtiles", "n_kwins")),
    "fold_rows": (PackedSpMatrixELL, (("cols", np.int32), ("vals", np.float32),
                                      ("fold_rows", np.int32)),
                  ("slots_per_row", "m_base")),
}

Packed = Union[PackedSpMatrix, PackedSpMatrixMXU, PackedSpMatrixEdge, PackedSpMatrixELL]

# HybridSplit's arrays with their dtypes
_SPLIT_ARRAYS = (("diag_offsets", np.int64), ("diag_vals", np.float32),
                 ("head_cols", np.int32), ("head_dense", np.float32),
                 ("head_rows", np.int32), ("head_rows_dense", np.float32))


def _copy_fields(cls, obj):
    return cls(**{f.name: getattr(obj, f.name) for f in fields(cls)})


def _arrays(obj, array_dtypes) -> dict:
    arrays = {}
    for name, dtype in array_dtypes:
        a = np.asarray(getattr(obj, name))
        if a.dtype != dtype:
            raise TypeError(f"{name} must be {np.dtype(dtype).name}, got {a.dtype}")
        arrays[name] = np.ascontiguousarray(a)
    return arrays


def from_reference(packed) -> Union[Packed, HybridSplit]:
    """Convert a ``sextans_tpu`` block, slab, edge or ELL pack, or a
    ``HybridSplit``, into this package's.

    The format is told by its index array: ``qm`` (slab), ``qrow`` (block),
    ``meta`` (edge), ``fold_rows`` (ELL) or ``diag_offsets`` (a hybrid
    split). Arrays are taken as NumPy with their dtypes checked, so the
    result is byte-identical to packing, or splitting, the same COO here. A
    bucketized ELL pack keeps its ``k_bucket``.
    """
    if hasattr(packed, "diag_offsets"):
        res = packed.residue
        return HybridSplit(
            m=int(packed.m), k=int(packed.k), nnz=int(packed.nnz),
            residue=COOMatrix(tuple(int(x) for x in res.shape), res.rows, res.cols,
                              res.vals),
            **_arrays(packed, _SPLIT_ARRAYS),
        )
    fmt = next((name for name in _FORMATS if hasattr(packed, name)), None)
    if fmt is None:
        raise TypeError(
            f"{type(packed).__name__} is not a block, slab, edge or ELL pack "
            "or a hybrid split (no qrow/qm/meta/fold_rows/diag_offsets array)"
        )
    cls, array_dtypes, scalars = _FORMATS[fmt]
    arrays = _arrays(packed, array_dtypes)
    perms = {}
    for name in ("col_perm", "row_perm"):
        p = getattr(packed, name, None)
        perms[name] = None if p is None else np.asarray(p, dtype=np.int32)
    out = cls(
        m=int(packed.m),
        k=int(packed.k),
        nnz=int(packed.nnz),
        config=_copy_fields(SpmmConfig, packed.config),
        stats=_copy_fields(PackStats, packed.stats),
        **{name: int(getattr(packed, name)) for name in scalars},
        **arrays,
        **perms,
    )
    if hasattr(packed, "k_bucket"):  # a bucketized ELL pack's B extent (ops/serve.py)
        out.__dict__["k_bucket"] = int(packed.k_bucket)
    return out
