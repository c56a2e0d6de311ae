"""SpmmPlan: a reusable, device-resident execution plan for one packed matrix.

The PyTorch counterpart of ``sextans_tpu.ops.plan.SpmmPlan``: the packed
arrays and the per-M-tile group ranges are uploaded once (memoized on the
packed object per device); each call pads B to ``k_padded`` and C to
``m_padded``, runs one kernel and slices the result. N is not padded: the
kernels mask a ragged last column chunk.

Backends keep the JAX package's names so that flags read the same:

* ``"pallas"`` — the block kernel (ops/spmm_block.py) over ``pack``;
* ``"mxu"``    — the slab kernels (ops/spmm_slab.py) over ``pack_mxu``; the
  skinny kernel when N <= 32;
* ``"xla"``    — the plain PyTorch block version, on any device;
* ``"auto"``   — ``"mxu"`` for a slab pack, else ``"pallas"``.

``device`` is explicit. On a CUDA device the plan launches the kernels; on
the CPU the same calls run their plain versions.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from sextans_tpu_torch.format.pack import PackedSpMatrix
from sextans_tpu_torch.format.pack_mxu import MSLAB, PackedSpMatrixMXU
from sextans_tpu_torch.ops.launch import check_pack_indices, group_ranges
from sextans_tpu_torch.ops.spmm_block import spmm_block_padded, spmm_block_padded_ref
from sextans_tpu_torch.ops.spmm_slab import (
    SKINNY_MAX_N,
    spmm_slab_padded,
    spmm_slab_skinny_padded,
)

__all__ = ["SpmmPlan", "BACKENDS", "resolve_device"]

BACKENDS = ("auto", "pallas", "mxu", "xla")


def resolve_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _upload(packed, device: torch.device):
    """Device copies of the packed arrays and group ranges, made once per
    device and kept on the packed object."""
    cache = packed.__dict__.setdefault("_dev_cache", {})
    key = str(device)
    if key not in cache:
        cfg = packed.config
        is_slab = isinstance(packed, PackedSpMatrixMXU)
        idx = packed.qm if is_slab else packed.qrow
        check_pack_indices(
            packed, idx, cfg.tile_m // (MSLAB if is_slab else 8)
        )
        tile_ptr, tile_groups = group_ranges(packed.group_mtile, packed.n_mtiles)

        def put(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(device)

        arrays = (
            put(packed.vals, np.float32),
            put(idx, np.int32),
            put(packed.bcol, np.int32),
            put(packed.group_mtile, np.int32),
            put(packed.group_kwin, np.int32),
        )
        ranges = (put(tile_ptr, np.int32), put(tile_groups, np.int32))
        cache[key] = (arrays, ranges)
    return cache[key]


class SpmmPlan:
    """SpMM executor for a fixed (packed A, N, backend, device)."""

    def __init__(self, packed, n: int, backend: str = "auto", *, device):
        is_slab = isinstance(packed, PackedSpMatrixMXU)
        if not is_slab and not isinstance(packed, PackedSpMatrix):
            raise TypeError(
                f"SpmmPlan takes a PackedSpMatrix or PackedSpMatrixMXU, not "
                f"{type(packed).__name__} (see format/convert.py for packs "
                "made by sextans_tpu)"
            )
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; expected one of {BACKENDS}")
        if backend == "auto":
            backend = "mxu" if is_slab else "pallas"
        if is_slab != (backend == "mxu"):
            raise ValueError(
                f"backend {backend!r} does not match packed format "
                f"{type(packed).__name__}"
            )
        cfg = packed.config
        if int(cfg.precise) != 0:
            raise NotImplementedError(
                "precise accumulation (SpmmConfig.precise=1/2) is not ported "
                "yet: ROADMAP.md queue 1 item 6"
            )
        if n < 1:
            raise ValueError(f"N must be positive, got {n}")
        self.backend = backend
        self.packed = packed
        self.m, self.k = packed.shape
        self.n = n
        self.device = resolve_device(device)
        self.arrays, self.ranges = _upload(packed, self.device)

        kw = dict(tile_m=cfg.tile_m, window_k=cfg.window_k,
                  block_k=cfg.block_k, group_blocks=cfg.group_blocks)
        if backend == "xla":
            run = functools.partial(spmm_block_padded_ref, **kw)
        else:
            kernel = (
                spmm_block_padded if backend == "pallas"
                else spmm_slab_skinny_padded if n <= SKINNY_MAX_N
                else spmm_slab_padded
            )
            run = functools.partial(kernel, ranges=self.ranges, **kw)
        self._run = run

        def as_index(p):
            return None if p is None else torch.as_tensor(
                np.asarray(p, dtype=np.int64), device=self.device
            )

        self._col_perm = as_index(packed.col_perm)
        self._row_perm = as_index(packed.row_perm)
        self._inv_row = None
        if packed.row_perm is not None:
            inv = np.empty(self.m, dtype=np.int64)
            inv[packed.row_perm] = np.arange(self.m)
            self._inv_row = as_index(inv)

    def _dense(self, x, shape, name) -> torch.Tensor:
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(x.shape)}")
        return x

    def pad_b(self, b) -> torch.Tensor:
        """B as the kernel takes it: column-permuted, padded to k_padded."""
        b = self._dense(b, (self.k, self.n), "B")
        if self._col_perm is not None:  # A was packed as A[:, col_perm]
            b = b[self._col_perm]
        return F.pad(b, (0, 0, 0, self.packed.k_padded - self.k)).contiguous()

    def pad_c(self, c) -> torch.Tensor:
        """C as the kernel takes it: row-permuted, padded to m_padded."""
        c = self._dense(c, (self.m, self.n), "C")
        if self._row_perm is not None:  # A was packed as A[row_perm, :]
            c = c[self._row_perm]
        return F.pad(c, (0, 0, 0, self.packed.m_padded - self.m)).contiguous()

    def _unpad(self, out: torch.Tensor) -> torch.Tensor:
        out = out[: self.m]
        return out if self._inv_row is None else out[self._inv_row]

    def __call__(self, b, alpha=1.0, beta=0.0, c=None) -> torch.Tensor:
        b_p = self.pad_b(b)
        if c is None:
            if float(beta) != 0.0:
                raise ValueError("beta != 0 requires an input C")
            # no-C path: the kernel never reads C; this view gives its shape
            c_p = torch.zeros(1, device=self.device).expand(
                self.packed.m_padded, self.n
            )
            out = self._run(*self.arrays, b_p, c_p, alpha, 0.0, with_c=False)
        else:
            out = self._run(*self.arrays, b_p, self.pad_c(c), alpha, beta)
        return self._unpad(out)

    def repeat(self, b, alpha=1.0, beta=0.0, c=None, times: int = 1) -> torch.Tensor:
        """Run the kernel ``times`` times on the current stream, feeding C
        back each time (the reference's rp_time loop). Padding and the row
        permutation happen once, outside the loop."""
        b_p = self.pad_b(b)
        if c is None:
            if float(beta) != 0.0:
                raise ValueError("beta != 0 requires an input C")
            c = torch.zeros((self.m, self.n), dtype=torch.float32)
        c_p = self.pad_c(c)
        for _ in range(times):
            c_p = self._run(*self.arrays, b_p, c_p, alpha, beta)
        return self._unpad(c_p)

