"""Shape-generic serving: one kernel library serves a family of matrices.

The PyTorch counterpart of ``sextans_tpu.ops.serve``. The reference serves
arbitrary A/B/C sizes at runtime with one compiled bitstream (the sizes are
kernel arguments, src/sextans.h:20-26). The JAX package restores that
property under XLA by **shape bucketing**: a pack padded to canonical
bucket dimensions (group count, M-tile count, K-window count rounded up a
geometric series) hits the same compiled executable as every other matrix
in its bucket.

The CUDA kernels here take every shape as a launch argument, and the kernel
library is built once per source hash (runtime/build.py:build_kernels), so
a bucket saves no compile on the card: no build runs after the first plan,
bucket or not. Serving keeps the JAX API and its padded-pack semantics, so
that both packages serve the same padded packs: :func:`bucketize_pack`
(held byte-identical to the JAX one by ``tests/test_torch_serve.py``),
:class:`ServePlan` and :class:`SpmmServer`.

Bucket padding is real, zero-valued work: the padding groups (or chunks)
extend the last real group's M-tile run (``parallel/partition.py:
_pad_shard_groups``), which the growth factor bounds at ``growth - 1``
(default 25 %) of the A stream; padded M-tiles and K-windows add only zero
rows of C and B.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from sextans_tpu_torch.format.pack_cache import PackCache
from sextans_tpu_torch.format.pack_edge import PackedSpMatrixEdge
from sextans_tpu_torch.format.pack_ell import PackedSpMatrixELL
from sextans_tpu_torch.ops.plan import FORMAT_OF, FORMAT_TABLE, FORMATS, SpmmPlan, resolve_device
from sextans_tpu_torch.parallel.partition import _pad_shard_groups
from sextans_tpu_torch.utils.config import SpmmConfig, cdiv, round_up

__all__ = ["SpmmServer", "ServePlan", "bucketize_pack", "bucket_up", "AUTO_BACKENDS"]

# format -> the backend "auto" serves it with: the first servable one, the
# pack's own kernel, on every device (on the CPU the plans run their plain versions)
AUTO_BACKENDS = {name: next(b for b, engine in f.backends.items() if engine.servable)
                 for name, f in FORMAT_TABLE.items()}


def bucket_up(x: int, growth: float = 1.25) -> int:
    """Smallest member >= x of the geometric bucket series 1, 2, 3, 4, 5,
    7, 9, ... (each step the previous rounded up by ``growth``)."""
    b = 1
    while b < x:
        b = max(b + 1, int(np.ceil(b * growth)))
    return b


def _bucketize_ell(packed: PackedSpMatrixELL, growth: float):
    """Pad an ELL pack so that its shapes sit on the bucket series: slots R,
    the real-row region (m_base), the virtual-row count, total padded rows,
    and the gather space K (``k_bucket``, the rows B is padded to). All
    padding contributes exact zeros: pad slots compute 0 * B[0, :], pad
    rows are all-zero slots, and pad virtual rows fold 0.0 into the last
    real fold target (repeating it keeps ``fold_rows`` ascending)."""
    cfg = packed.config
    m_block = cfg.tile_m
    r = packed.slots_per_row
    n_virt = packed.n_virt
    r_b = bucket_up(r, growth)
    m_base_b = round_up(bucket_up(packed.m_base, growth), 8)
    n_virt_b = bucket_up(n_virt, growth) if n_virt else 0
    blocks_b = bucket_up(cdiv(m_base_b + n_virt_b, m_block), growth)
    m_padded_b = blocks_b * m_block
    cols = np.zeros((m_padded_b, r_b), np.int32)
    vals = np.zeros((m_padded_b, r_b), np.float32)
    cols[: packed.m_base, :r] = packed.cols[: packed.m_base]
    vals[: packed.m_base, :r] = packed.vals[: packed.m_base]
    fold = np.zeros(n_virt_b, np.int32)
    if n_virt:
        cols[m_base_b : m_base_b + n_virt, :r] = packed.cols[
            packed.m_base : packed.m_base + n_virt
        ]
        vals[m_base_b : m_base_b + n_virt, :r] = packed.vals[
            packed.m_base : packed.m_base + n_virt
        ]
        fold[:n_virt] = packed.fold_rows
        fold[n_virt:] = packed.fold_rows[-1]
    out = dataclasses.replace(
        packed, cols=cols, vals=vals, fold_rows=fold,
        slots_per_row=r_b, m_base=m_base_b,
    )
    out.__dict__["k_bucket"] = bucket_up(packed.k, growth)
    return out


def bucketize_pack(packed, growth: float = 1.25):
    """Pad a packed matrix to canonical bucket dimensions.

    Returns a pack whose (groups or chunks, n_mtiles, n_kwins) are bucket
    values, with zero-valued padding groups extending the last real group's
    M-tile run. ELL packs bucket on (R, m_base, n_virt, row blocks, K)
    instead: see :func:`_bucketize_ell`. The arrays are byte-identical to
    ``sextans_tpu.ops.serve.bucketize_pack``'s.
    """
    if isinstance(packed, PackedSpMatrixELL):
        return _bucketize_ell(packed, growth)
    n_units = packed.n_chunks if isinstance(packed, PackedSpMatrixEdge) else packed.n_groups
    target_mtiles = bucket_up(packed.n_mtiles, growth)
    target_kwins = bucket_up(packed.n_kwins, growth)
    out = _pad_shard_groups(packed, bucket_up(n_units, growth))
    if target_mtiles != packed.n_mtiles or target_kwins != packed.n_kwins or out is packed:
        out = dataclasses.replace(out, n_mtiles=target_mtiles, n_kwins=target_kwins)
    return out


class ServePlan(SpmmPlan):
    """Executor for one served (bucketized) pack on one device.

    An :class:`~sextans_tpu_torch.ops.plan.SpmmPlan` over the bucketized
    pack: the same upload memo (one upload and one set of host scans per
    pack and device), the same kernel wrappers, B and C padded on the
    device, and ``__call__`` returning a tensor on the plan's device.
    :meth:`call_padded` takes bucket-shaped device tensors. ``backend`` is
    one the server may run: ``pallas``, ``xla``, ``mxu``, ``edge`` or
    ``ell``. N is not padded, so the JAX plan's ``tile_n`` is dropped.
    """

    def __init__(self, packed, n: int, backend: str, *, device):
        # the kernel gets B and C as they come: a degree-reordered pack
        # needs the B[col_perm] / C[row_perm] plumbing of SpmmPlan
        for perm in ("col_perm", "row_perm"):
            if getattr(packed, perm, None) is not None:
                raise ValueError(
                    f"ServePlan does not support reordered packs "
                    f"(packed.{perm} is set); pack without reorder_cols/"
                    f"reorder_rows for serving, or use SpmmPlan"
                )
        _check_servable(backend)
        super().__init__(packed, n, backend, device=device)
        self.m_padded = packed.m_padded
        # ELL buckets K too (k_bucket, stamped by _bucketize_ell)
        self.k_padded = getattr(packed, "k_bucket", packed.k_padded)

    def call_padded(self, b_padded, c_padded, alpha, beta, *, with_c: bool = True):
        """Bucket-shaped call: (k_padded, N) B and (m_padded, N) C, f32 and
        contiguous on the plan's device, in; the padded output out."""
        return self._run(*self.arrays, b_padded, c_padded, alpha, beta, with_c=with_c)


def _check_servable(backend: str) -> None:
    if backend not in FORMAT_OF:
        raise ValueError(f"unknown backend {backend!r}; expected one of "
                         f"{tuple(FORMAT_OF)}")
    fmt = FORMAT_OF[backend]
    if not FORMAT_TABLE[fmt].backends[backend].servable:
        raise ValueError(
            f"backend {backend!r} not servable, as in the JAX package (its "
            f"tables are per-matrix shaped); serve fmt={fmt!r} with the "
            f"{AUTO_BACKENDS[fmt]!r} engine"
        )


class SpmmServer:
    """Bucketed multi-matrix SpMM service on one device.

    Fixes (N, tiling config, format, backend, device) once; then
    ``plan(coo)`` serves any matrix. ``backend="auto"`` runs the format's
    own kernel (``AUTO_BACKENDS``): K3 for ``vpu``, K1/K2 for ``mxu``, K4
    for ``edge``, and the plain ``ell`` engine for ``ell``. ``pack_cache``
    (a :class:`~sextans_tpu_torch.format.pack_cache.PackCache`) keeps packs
    across processes: ``plan(coo, name)`` looks the pack up by ``name``.
    """

    def __init__(
        self,
        n: int,
        *,
        config: SpmmConfig = SpmmConfig(),
        fmt: str = "vpu",
        backend: str = "auto",
        growth: float = 1.25,
        pack_cache=None,
        device,
    ):
        if fmt not in AUTO_BACKENDS:
            raise ValueError(f"SpmmServer supports vpu/mxu/edge/ell formats, got {fmt!r}")
        if backend == "auto":
            backend = AUTO_BACKENDS[fmt]
        _check_servable(backend)
        if FORMAT_OF[backend] != fmt:
            raise ValueError(f"backend {backend!r} does not run the {fmt!r} format")
        if n < 1:
            raise ValueError(f"N must be positive, got {n}")
        self.n = n
        self.config = config
        self.fmt = fmt
        self.backend = backend
        self.growth = growth
        self.pack_cache = pack_cache
        self.device = resolve_device(device)
        self._buckets: set = set()

    def bucket_signature(self, packed) -> tuple:
        """The shapes that make a bucket: the JAX server's jit-cache key
        surrogate, without ``tile_n``."""
        if isinstance(packed, PackedSpMatrixELL):
            return (packed.m_padded, packed.slots_per_row, packed.n_virt, packed.m_base,
                    getattr(packed, "k_bucket", packed.k), self.backend)
        units = packed.n_chunks if isinstance(packed, PackedSpMatrixEdge) else packed.n_groups
        return (units, packed.n_mtiles, packed.n_kwins, self.backend)

    def plan(self, coo, name: Optional[str] = None) -> ServePlan:
        """Pack (through the cache where a ``pack_cache`` and ``name`` are
        given), bucket-pad and return the :class:`ServePlan`.
        ``plan.bucket_new`` says whether this server had seen the bucket."""
        if self.pack_cache is not None and name is not None:
            packed = self.pack_cache.get_or_pack(name, coo, self.config, self.fmt)
            # a cached pack keeps its bucketized twin in the memo that its
            # kernel-knob variants share (PackCache._with_cfg), so that every
            # server of the bucket reuses one upload and one set of scans
            memo = packed.__dict__.setdefault("_dev_cache", {})
            key = ("bucketized", self.growth)
            if key not in memo:
                memo[key] = bucketize_pack(packed, self.growth)
            bucketed = PackCache._with_cfg(memo[key], self.config)
        else:
            bucketed = bucketize_pack(FORMATS[self.fmt](coo, self.config), self.growth)
        sig = self.bucket_signature(bucketed)
        p = ServePlan(bucketed, self.n, self.backend, device=self.device)
        p.bucket_new = sig not in self._buckets
        self._buckets.add(sig)
        return p
