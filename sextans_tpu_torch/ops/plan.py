"""SpmmPlan: a reusable, device-resident execution plan for one packed matrix.

The PyTorch counterpart of ``sextans_tpu.ops.plan.SpmmPlan``: the packed
arrays (and the host scan that their kernel walks: for the ELL format on a
CUDA device only) are uploaded once (memoized on the packed object per
device and, for the scans, per kernel);
each call pads B to ``k_padded`` and C to ``m_padded``, runs one kernel and
slices the result, except on the ``ell_pallas`` route, whose kernel takes
the caller's B and C where they lie (``k_padded`` is K there) and writes an
(M, N) output. N is not padded: the kernels mask a ragged last column chunk.

Backends keep the JAX package's names so that flags read the same:

* ``"pallas"``     — the block kernel (ops/spmm_block.py) over ``pack``;
* ``"mxu"``        — the slab kernels (ops/spmm_slab.py) over ``pack_mxu``;
  the skinny kernel when N <= 32;
* ``"xla"``        — the plain PyTorch block version, on any device; it
  ignores ``SpmmConfig.precise``, as the JAX plan's ``xla`` backend does;
* ``"edge"``       — the edge kernel (ops/spmm_edge.py) over ``pack_edge``;
* ``"ell_pallas"`` — the ELL gather kernel (ops/spmm_ell.py) over
  ``pack_ell``;
* ``"ell"``        — the plain PyTorch ELL engine, on any device;
* ``"auto"``       — the pack's kernel: ``"mxu"``, ``"edge"``,
  ``"ell_pallas"`` or ``"pallas"``.

``device`` is explicit. On a CUDA device the plan launches the kernels; on
the CPU the same calls run their plain versions. ``SpmmConfig.precise`` (1
or 2) runs the compensated levels of the block, slab, edge and ELL kernels
and the f64 ``ell`` engine; ``xla`` ignores it.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from sextans_tpu_torch.format.pack import PackedSpMatrix, pack
from sextans_tpu_torch.format.pack_edge import PackedSpMatrixEdge, pack_edge
from sextans_tpu_torch.format.pack_ell import PackedSpMatrixELL, pack_ell
from sextans_tpu_torch.format.pack_mxu import MSLAB, PackedSpMatrixMXU, pack_mxu
from sextans_tpu_torch.ops.launch import (
    check_edge_pack,
    check_ell_pack,
    check_pack_indices,
    ell_fold_count,
    ell_tiles,
    need,
    row_runs,
    slab_visits,
    stripe_visits,
)
from sextans_tpu_torch.ops.spmm_block import spmm_block_padded, spmm_block_padded_ref
from sextans_tpu_torch.ops.spmm_edge import spmm_edge_padded
from sextans_tpu_torch.ops.spmm_ell import spmm_ell_gather_padded, spmm_ell_padded_ref
from sextans_tpu_torch.ops.spmm_slab import (
    SKINNY_MAX_N,
    slab_image,
    spmm_slab_padded,
    spmm_slab_skinny_padded,
)
from sextans_tpu_torch.utils.profiling import annotate, count, timed

__all__ = ["SpmmPlan", "BACKENDS", "BACKEND_FORMATS", "PACKS", "FORMATS", "resolve_device",
           "dense_operand"]

# backend -> (the packer that makes its format, the pack type it runs on);
# "auto" picks the first backend listed for the pack's type
BACKEND_FORMATS = {
    "pallas": (pack, PackedSpMatrix),
    "xla": (pack, PackedSpMatrix),
    "mxu": (pack_mxu, PackedSpMatrixMXU),
    "edge": (pack_edge, PackedSpMatrixEdge),
    "ell_pallas": (pack_ell, PackedSpMatrixELL),
    "ell": (pack_ell, PackedSpMatrixELL),
}
BACKENDS = ("auto", *BACKEND_FORMATS)
PACKS = tuple(dict.fromkeys(kind for _, kind in BACKEND_FORMATS.values()))
# the JAX package's format names -> their packers
FORMATS = {"vpu": pack, "mxu": pack_mxu, "edge": pack_edge, "ell": pack_ell}


def resolve_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def dense_operand(x, shape, name: str, device: torch.device) -> torch.Tensor:
    """``x`` (array or tensor) as an f32 tensor on ``device``; raises unless
    its shape is ``shape``."""
    x = torch.as_tensor(x, dtype=torch.float32, device=device)
    if tuple(x.shape) != shape:
        raise ValueError(f"{name} must be {shape}, got {tuple(x.shape)}")
    return x


def _put(a, dtype, device):
    """``a`` as a ``dtype`` tensor on ``device``. A read-only array (a raw
    pack-cache entry, memory-mapped by ``format/pack_cache.py:_raw_load``) is
    copied on the host first: ``torch.from_numpy`` warns on it, and on the
    CPU the tensor would alias the file mapping, where a write faults. The
    copy costs one host pass over the pack, once per device; the memmap
    still saves the inflate of an ``.npz``."""
    a = np.ascontiguousarray(a, dtype=dtype)
    if not a.flags.writeable:
        a = a.copy()
    return torch.from_numpy(a).to(device)


def _scan(packed, live):
    """The host scan that the kernels of ``packed`` walk: ``row_runs`` for
    the edge format (its pads are marked in ``meta``: it reads no values),
    ``stripe_visits`` for the block format and ``slab_visits`` for the slab
    format (K1 and K2), over the nonzero slots ``live``."""
    if isinstance(packed, PackedSpMatrixEdge):
        return row_runs(packed)
    scan = slab_visits if isinstance(packed, PackedSpMatrixMXU) else stripe_visits
    return scan(packed, live)


@timed("upload_s")
def _upload(packed, device: torch.device, structure=None):
    """Device copies of the packed arrays and the host scan their kernels
    walk (:func:`_scan`; K5's :func:`~sextans_tpu_torch.ops.launch.ell_tiles`
    on a CUDA device only), each made once per device and kept on the packed
    object. Returns ``(arrays, ranges)``; ``ranges`` is None for the ELL
    format on the CPU. An ELL pack's ``fold_rows`` is uploaded up to
    :func:`~sextans_tpu_torch.ops.launch.ell_fold_count`; the pack's entries,
    slots, padded rows and folded virtual rows are counted with that count
    (``ell.*``, ``utils/profiling.py``), once a pack, and once more where
    plans over ``structure`` make their own. The scans read the
    nonzero values, or the slots ``structure`` marks where it is given (a
    plan over values given at call time); the two are kept under keys of
    their own."""
    cache = packed.__dict__.setdefault("_dev_cache", {})
    key = str(device) if structure is None else (str(device), "structure")
    if isinstance(packed, PackedSpMatrixELL):
        n_key = "n_fold" if structure is None else ("n_fold", "structure")
        if n_key not in cache:  # checked and counted once per pack
            check_ell_pack(packed)
            cache[n_key] = ell_fold_count(packed, structure)
            count("ell.entries", packed.nnz)
            count("ell.slots", packed.cols.size)
            count("ell.rows", packed.m_padded)
            count("ell.fold_rows", cache[n_key])
        # a run of repeated all-zero virtual rows (a bucket's) folds once
        if cache[n_key] < packed.n_virt:
            packed = dataclasses.replace(packed, fold_rows=packed.fold_rows[:cache[n_key]])
    if key not in cache:
        if isinstance(packed, PackedSpMatrixELL):
            named = ((packed.vals, np.float32), (packed.cols, np.int32),
                     (packed.fold_rows, np.int32))
        elif isinstance(packed, PackedSpMatrixEdge):
            check_edge_pack(packed)
            named = ((packed.vals, np.float32), (packed.meta, np.int32),
                     (packed.chunk_mtile, np.int32), (packed.chunk_kwin, np.int32))
        else:
            is_slab = isinstance(packed, PackedSpMatrixMXU)
            idx = packed.qm if is_slab else packed.qrow
            check_pack_indices(packed, idx, packed.config.tile_m // (MSLAB if is_slab else 8))
            named = ((packed.vals, np.float32), (idx, np.int32),
                     (packed.bcol, np.int32), (packed.group_mtile, np.int32),
                     (packed.group_kwin, np.int32))
        cache[key] = tuple(_put(a, dtype, device) for a, dtype in named)
    scan_key = (key, "scan")
    if isinstance(packed, PackedSpMatrixELL):
        if device.type != "cuda":  # the plain versions walk no tiles
            return cache[key], None
        if scan_key not in cache:
            tiles = ell_tiles(packed)
            cache[scan_key] = tiles._replace(
                **{f: _put(getattr(tiles, f), np.int32, device) for f in tiles._fields[:-1]})
        return cache[key], cache[scan_key]
    if scan_key not in cache:
        cache[scan_key] = tuple(_put(r, np.int32, device) for r in _scan(packed, structure))
    return cache[key], cache[scan_key]


@timed("upload_s")
def _slab_image(packed, device: torch.device, arrays):
    """K1's operand tiles (:func:`~sextans_tpu_torch.ops.spmm_slab.slab_image`),
    made once per device from the uploaded values and kept beside them."""
    cache = packed.__dict__["_dev_cache"]
    key = (str(device), "slab_image")
    if key not in cache:
        cache[key] = slab_image(arrays[0], packed.config.block_k)
    return cache[key]


def _pad_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    """``x`` padded with zero rows to ``rows``, contiguous; ``x`` itself
    where it is both already."""
    if rows > x.shape[0]:
        x = F.pad(x, (0, 0, 0, rows - x.shape[0]))
    return x.contiguous()


def _runner(packed, backend: str, n: int, ranges, image=None):
    """The padded-operand function of ``backend``, with its static
    arguments bound: ``run(*arrays, b_p, c_p, alpha, beta, with_c=...)``."""
    cfg = packed.config
    precise = int(cfg.precise)
    if backend == "ell":
        return functools.partial(spmm_ell_padded_ref, m_base=packed.m_base, precise=precise)
    if backend == "ell_pallas":
        return functools.partial(spmm_ell_gather_padded, m_base=packed.m_base,
                                 ranges=ranges, precise=precise)
    if backend == "edge":
        return functools.partial(
            spmm_edge_padded, tile_m=cfg.tile_m, window_k=cfg.window_k,
            edge_chunk=cfg.edge_chunk, masked=cfg.edge_masked, ranges=ranges,
            precise=precise)
    kw = dict(tile_m=cfg.tile_m, window_k=cfg.window_k,
              block_k=cfg.block_k, group_blocks=cfg.group_blocks)
    if backend == "xla":
        return functools.partial(spmm_block_padded_ref, **kw)
    if backend == "mxu" and n > SKINNY_MAX_N:
        return functools.partial(spmm_slab_padded, ranges=ranges, image=image,
                                 precise=precise, **kw)
    kernel = spmm_block_padded if backend == "pallas" else spmm_slab_skinny_padded
    return functools.partial(kernel, ranges=ranges, precise=precise, **kw)


class SpmmPlan:
    """SpMM executor for a fixed (packed A, N, backend, device).

    ``structure`` (internal, for ``ops/autodiff.py``): the slots that the
    pack's COO entries fill (:func:`~sextans_tpu_torch.ops.launch.structure_mask`).
    Such a plan runs over values given at each call (:meth:`run_values`):
    its host scans walk every block and fold every virtual row that holds
    an entry, whatever the pack's own values, and it keeps no K1 operand
    tiles (``image`` is None; :meth:`run_values` makes them from each call's
    values, so its ``__call__`` cannot run K1 on the tensor cores).
    """

    def __init__(self, packed, n: int, backend: str = "auto", *, device, structure=None):
        if type(packed) not in PACKS:
            raise TypeError(
                "SpmmPlan takes a PackedSpMatrix, PackedSpMatrixMXU, "
                f"PackedSpMatrixEdge or PackedSpMatrixELL, not "
                f"{type(packed).__name__} (see format/convert.py for packs "
                "made by sextans_tpu)"
            )
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; expected one of {BACKENDS}")
        if backend == "auto":
            backend = next(name for name, (_, kind) in BACKEND_FORMATS.items()
                           if kind is type(packed))
        if BACKEND_FORMATS[backend][1] is not type(packed):
            raise ValueError(
                f"backend {backend!r} does not match packed format "
                f"{type(packed).__name__}"
            )
        if n < 1:
            raise ValueError(f"N must be positive, got {n}")
        self.backend = backend
        self.packed = packed
        self.m, self.k = packed.shape
        self.n = n
        self.k_padded = packed.k_padded  # the rows B is padded to
        self.device = resolve_device(device)
        if structure is not None and structure.shape != packed.vals.shape:
            raise ValueError(f"structure must be {packed.vals.shape}, got {structure.shape}")
        self.arrays, self.ranges = _upload(packed, self.device, structure)
        # K1's operand tiles, where K1 runs on the tensor cores (plain mode on a card)
        self._tc = (backend == "mxu" and n > SKINNY_MAX_N and not packed.config.precise
                    and self.device.type == "cuda")
        self.image = (_slab_image(packed, self.device, self.arrays)
                      if self._tc and structure is None else None)
        self._run = _runner(packed, backend, n, self.ranges, self.image)

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
        # the rows of a call's C and output: K5 takes them at their real size
        # (csrc/spmm_ell.cu), every other kernel padded to m_padded
        self._in_place = backend == "ell_pallas" and packed.m_base == self.m
        self._c_rows = self.m if self._in_place else packed.m_padded
        # the bytes of B, and of B and C, that a call makes (pads and gathers)
        b_bytes = (4 * self.k_padded * n
                   if self.k_padded > self.k or packed.col_perm is not None else 0)
        c_bytes = (4 * self._c_rows * n
                   if self._c_rows > self.m or packed.row_perm is not None else 0)
        self._pad_bytes = (b_bytes, b_bytes + c_bytes)

    def pad_b(self, b) -> torch.Tensor:
        """B as the kernel takes it: column-permuted, padded to k_padded."""
        b = dense_operand(b, (self.k, self.n), "B", self.device)
        if self._col_perm is not None:  # A was packed as A[:, col_perm]
            b = b[self._col_perm]
        return _pad_rows(b, self.k_padded)

    def pad_c(self, c, rows: Optional[int] = None) -> torch.Tensor:
        """C as the kernel takes it: row-permuted, padded to ``rows``
        (m_padded by default)."""
        c = dense_operand(c, (self.m, self.n), "C", self.device)
        if self._row_perm is not None:  # A was packed as A[row_perm, :]
            c = c[self._row_perm]
        return _pad_rows(c, self.packed.m_padded if rows is None else rows)

    def no_c(self, rows: Optional[int] = None) -> torch.Tensor:
        """The C of a call without one: the kernel never reads it; this
        view gives its shape, ``rows`` (m_padded by default) by N."""
        return torch.zeros(1, device=self.device).expand(
            self.packed.m_padded if rows is None else rows, self.n)

    def run_values(self, pv: torch.Tensor, b_p, c_p, alpha, beta, *,
                   with_c: bool = True) -> torch.Tensor:
        """The plan's kernel over ``pv``, packed values given at this call
        (the pack's values' shape, f32, on the plan's device), in place of
        the uploaded ones: padded B and C in (:meth:`pad_b`, :meth:`pad_c`,
        or :meth:`no_c` with ``with_c=False``), the padded output out. Where
        K1 runs on the tensor cores, its operand tiles are made from ``pv``
        for this call (:func:`~sextans_tpu_torch.ops.spmm_slab.slab_image`)."""
        need(pv, "pv", torch.float32, self.arrays[0].shape, self.device)
        image = {}
        if self._tc:
            with annotate("sx.plan.slab_image"):
                image["image"] = slab_image(pv, self.packed.config.block_k)
        return self._run(pv, *self.arrays[1:], b_p, c_p, alpha, beta, with_c=with_c, **image)

    def unpad(self, out: torch.Tensor) -> torch.Tensor:
        """The (M, N) result of a kernel output of M or more rows."""
        if out.shape[0] != self.m:
            out = out[: self.m]
        return out if self._inv_row is None else out[self._inv_row]

    def __call__(self, b, alpha=1.0, beta=0.0, c=None) -> torch.Tensor:
        """``alpha * A @ b + beta * c`` (M, N), inside the span
        ``sx.plan.call``. Counts ``plan.calls``, ``plan.pad_bytes`` and, on
        the ``ell_pallas`` route, whose C and output have M rows,
        ``plan.in_place`` (``utils/profiling.py``)."""
        with_c = c is not None
        if not with_c:
            if float(beta) != 0.0:
                raise ValueError("beta != 0 requires an input C")
            beta = 0.0
        count("plan.calls")
        count("plan.pad_bytes", self._pad_bytes[with_c])
        if self._in_place:
            count("plan.in_place")
        with annotate("sx.plan.call"):
            b_p = self.pad_b(b)
            c_p = self.pad_c(c, self._c_rows) if with_c else self.no_c(self._c_rows)
            return self.unpad(self._run(*self.arrays, b_p, c_p, alpha, beta, with_c=with_c))

    def repeat(self, b, alpha=1.0, beta=0.0, c=None, times: int = 1) -> torch.Tensor:
        """Run the kernel ``times`` times on the current stream, feeding C
        back each time (the reference's rp_time loop). Padding and the row
        permutation happen once, outside the loop; the carry is the whole
        padded C, virtual ELL rows included, as in the JAX package."""
        b_p = self.pad_b(b)
        if c is None:
            if float(beta) != 0.0:
                raise ValueError("beta != 0 requires an input C")
            c = torch.zeros((self.m, self.n), dtype=torch.float32)
        c_p = self.pad_c(c)
        for _ in range(times):
            c_p = self._run(*self.arrays, b_p, c_p, alpha, beta)
        return self.unpad(c_p)
