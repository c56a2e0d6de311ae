"""Carry a packed matrix across from the JAX package.

A ``sextans_tpu`` pack (``PackedSpMatrix`` or ``PackedSpMatrixMXU``) holds
NumPy arrays and plain fields only, so it converts without importing
``sextans_tpu``: fields are read by name. Tests use this to feed the same
packed A to both packages.
"""

from __future__ import annotations

from dataclasses import fields
from typing import Union

import numpy as np

from sextans_tpu_torch.format.pack import PackedSpMatrix, PackStats
from sextans_tpu_torch.format.pack_mxu import PackedSpMatrixMXU
from sextans_tpu_torch.utils.config import SpmmConfig

__all__ = ["from_reference"]


def _copy_fields(cls, obj):
    return cls(**{f.name: getattr(obj, f.name) for f in fields(cls)})


def from_reference(packed) -> Union[PackedSpMatrix, PackedSpMatrixMXU]:
    """Convert a ``sextans_tpu`` block or slab pack into this package's.

    The format is told by its index array: ``qm`` (slab format) or ``qrow``
    (block format). Arrays are taken as NumPy with their dtypes checked, so
    the result is byte-identical to packing the same COO here.
    """
    if hasattr(packed, "qm"):
        cls, idx_name = PackedSpMatrixMXU, "qm"
    elif hasattr(packed, "qrow"):
        cls, idx_name = PackedSpMatrix, "qrow"
    else:
        raise TypeError(
            f"{type(packed).__name__} is neither a block nor a slab pack "
            "(no qrow/qm array)"
        )
    arrays = {}
    for name, dtype in (
        ("vals", np.float32),
        (idx_name, np.int32),
        ("bcol", np.int32),
        ("group_mtile", np.int32),
        ("group_kwin", np.int32),
    ):
        a = np.asarray(getattr(packed, name))
        if a.dtype != dtype:
            raise TypeError(f"{name} must be {np.dtype(dtype).name}, got {a.dtype}")
        arrays[name] = np.ascontiguousarray(a)
    perms = {}
    for name in ("col_perm", "row_perm"):
        p = getattr(packed, name, None)
        perms[name] = None if p is None else np.asarray(p, dtype=np.int32)
    return cls(
        m=int(packed.m),
        k=int(packed.k),
        nnz=int(packed.nnz),
        config=_copy_fields(SpmmConfig, packed.config),
        n_mtiles=int(packed.n_mtiles),
        n_kwins=int(packed.n_kwins),
        stats=_copy_fields(PackStats, packed.stats),
        **arrays,
        **perms,
    )
