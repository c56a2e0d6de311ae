"""Hybrid structure-split SpMM: diagonals + dense head columns and rows +
residue, on one CUDA device or the CPU.

The PyTorch counterpart of ``sextans_tpu.ops.hybrid``. ``split_structure``
is its host NumPy code, copied, so that both packages split every matrix
into the same arrays (held array-identical by ``tests/test_torch_hybrid.py``):

* **diagonals**: diagonal ``off`` stores ``A[i, i + off]`` as a dense row of
  ``diag_vals``; its product is a shifted elementwise multiply-add, run by
  the DIA kernels (ops/spmm_dia.py: K6 for N > 32, K7 for N <= 32);
* **dense head columns**: the hub columns, lifted into a dense (M, H)
  matrix, one matmul ``head @ B[head_cols]``;
* **dense head rows**: the hub rows, a dense (R, K) matmul whose rows are
  added into their C rows;
* **residue**: the rest, in original coordinates, through one
  :class:`~sextans_tpu_torch.ops.plan.SpmmPlan`.

``HybridSpmmPlan`` computes one step in the JAX package's order: the DIA
epilogue ``alpha * diag + beta * C`` (or ``beta * C``), then
``+ alpha * head``, then the hub rows, and the partial result goes to the
residue's plan as its C with beta = 1. It has two ways to add the head
columns and hub rows:

* on the ``"pallas"`` DIA route (K6 or K7; their plain version on the
  CPU) by the row-sparse pass (``ops/hybrid_hub.py:hybrid_hub``,
  ``csrc/hybrid_hub.cu`` on a card) over the planes' entries as lists,
  made at upload, touching no row without one. The plain step adds both
  parts into the DIA kernel's output in place, in one pass. The planes are
  not uploaded: 99.5 % of their slots are zeros on a circuit split, which
  two f32 GEMMs would multiply and two (M, N) passes add;
* on the ``"xla"`` route (the JAX package's composition on any device) by
  the dense planes and their f32 matmuls.

With ``precise`` 1 or 2 the plan runs the JAX package's precise
composition: each part on its own at alpha = 1 (the residue's kernel and
the DIA kernel compensated; on the ``"pallas"`` route the head columns and
the hub rows each by a compensated pass of their own into zeros, on
``"xla"`` by the matmuls, uncompensated as in the JAX package), then
``beta * C`` and ``alpha`` times each part combined with error-free
transforms and rounded once per element.

The choice follows what the plan observes, the resolved ``dia_backend``
and ``precise``; the split is the same either way.

Under a profiler a step is the span ``sx.hybrid.call`` and its hub parts
(the row-sparse pass, or the matmuls with their gather and adds) the span
``sx.hybrid.dense`` (``utils/profiling.py``); the DIA kernels and the
residue's plan open their own inside it. ``split_structure`` counts as
``pack_s`` and the plan's uploads as ``upload_s``; ``hybrid.calls`` counts
the steps, the ``hybrid.diag_*``, ``hybrid.dense_*`` and
``hybrid.residue_entries`` counters each split's parts, once a split, and
``hybrid.hub_entries`` and ``hybrid.hub_rows`` the row-sparse pass's
entries and rows, once a plan that makes its lists.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from sextans_tpu_torch.format.coo import COOMatrix
from sextans_tpu_torch.ops.df32 import two_prod, two_sum
from sextans_tpu_torch.ops.hybrid_hub import hub_lists, hybrid_hub
from sextans_tpu_torch.ops.launch import f32, no_tf32, put
from sextans_tpu_torch.ops.plan import (
    BACKENDS,
    FORMAT_OF,
    FORMATS,
    SpmmPlan,
    dense_operand,
    resolve_device,
)
from sextans_tpu_torch.ops.spmm_dia import (
    dia_entries,
    dia_plan,
    entry_walk_slots,
    spmm_dia,
    spmm_dia_ref,
    spmm_dia_skinny,
)
from sextans_tpu_torch.ops.spmm_slab import SKINNY_MAX_N
from sextans_tpu_torch.utils.config import SpmmConfig
from sextans_tpu_torch.utils.profiling import annotate, count, timed

__all__ = ["HybridSplit", "split_structure", "HybridSpmmPlan", "SPLIT_VERSION",
           "DIA_BACKENDS", "check_split"]

# The split rule's cost constants: the JAX package's TPU v5e model
# (sextans_tpu/utils/autotune.py: BYTES_PER_CYCLE, EDGE_CYCLES_FIXED,
# EDGE_CYCLES_PER_128LANES), kept at their values so that both packages split
# every matrix identically. They say nothing about the H100; recalibrating
# them for it is ROADMAP.md queue 1 item 6.
BYTES_PER_CYCLE = 850.0
EDGE_CYCLES_FIXED = 6.0
EDGE_CYCLES_PER_128LANES = 20.0

# The JAX package's split version, bumped with split_structure's selection
# logic (its pack cache keys cached splits on it); kept equal to it.
SPLIT_VERSION = 3


@dataclass
class HybridSplit:
    """Structure decomposition of a sparse matrix (host-side)."""

    m: int
    k: int
    nnz: int
    # diagonals: offsets c (col - row); vals[d, i] = A[i, i + offsets[d]]
    diag_offsets: np.ndarray  # (D,) int64
    diag_vals: np.ndarray  # (D, m) float32
    # dense head columns (original column ids) and their dense values
    head_cols: np.ndarray  # (H,) int32
    head_dense: np.ndarray  # (m, H) float32
    # dense head rows (hub rows, e.g. circuit power nets): full dense rows
    head_rows: np.ndarray  # (R,) int32
    head_rows_dense: np.ndarray  # (R, k) float32
    residue: COOMatrix

    @property
    def diag_nnz(self) -> int:
        return int(np.count_nonzero(self.diag_vals))

    @property
    def head_nnz(self) -> int:
        return int(np.count_nonzero(self.head_dense))

    @property
    def head_row_nnz(self) -> int:
        return int(np.count_nonzero(self.head_rows_dense))

    def summary(self) -> str:
        return (
            f"HybridSplit(m={self.m}, k={self.k}, nnz={self.nnz}: "
            f"{self.diag_offsets.size} diagonals ({self.diag_nnz}), "
            f"{self.head_cols.size} head cols ({self.head_nnz}), "
            f"{self.head_rows.size} head rows ({self.head_row_nnz}), "
            f"residue {self.residue.nnz})"
        )

    # -- persistence: split_structure costs minutes of host scatter work on
    #    10M+-edge matrices and is re-run per (matrix, N) benchmark row, so
    #    it joins the pack cache (format/pack_cache.py) as a cacheable
    #    preprocessing artifact. The dense planes compress well (they are
    #    mostly zeros: only head/diag entries are populated). --
    def save(self, path) -> None:
        np.savez_compressed(
            Path(path),
            dims=np.array([self.m, self.k, self.nnz], dtype=np.int64),
            diag_offsets=self.diag_offsets,
            diag_vals=self.diag_vals,
            head_cols=self.head_cols,
            head_dense=self.head_dense,
            head_rows=self.head_rows,
            head_rows_dense=self.head_rows_dense,
            residue_rows=self.residue.rows,
            residue_cols=self.residue.cols,
            residue_vals=self.residue.vals,
        )

    @staticmethod
    def load(path) -> "HybridSplit":
        z = np.load(Path(path))
        m, k, nnz = (int(x) for x in z["dims"])
        return HybridSplit(
            m=m,
            k=k,
            nnz=nnz,
            diag_offsets=z["diag_offsets"],
            diag_vals=z["diag_vals"],
            head_cols=z["head_cols"],
            head_dense=z["head_dense"],
            head_rows=z["head_rows"],
            head_rows_dense=z["head_rows_dense"],
            residue=COOMatrix(
                (m, k), z["residue_rows"], z["residue_cols"],
                z["residue_vals"],
            ),
        )


def _residue_edge_cycles(n: int) -> float:
    """Best-case modeled cycles to process ONE residue nonzero across the
    full N width (the edge-kernel model of the constants above)."""
    best = float("inf")
    for tn in (128, 256, 512):
        panels = max(1, -(-n // tn))
        best = min(
            best,
            EDGE_CYCLES_FIXED * panels + EDGE_CYCLES_PER_128LANES * n / 128,
        )
    return best


def _cost_based_degree(m_other: int, n: int, length: int) -> int:
    """Marginal break-even degree for lifting one column (or row) into the
    dense head: lift when ``deg * residue_edge_cycles`` exceeds the dense
    strip's cost (MXU flops at ~10k FLOP/cycle + its HBM read)."""
    dense_cycles = 2.0 * length * n / 10000.0 + length * 4 / BYTES_PER_CYCLE
    return max(4, int(dense_cycles / max(_residue_edge_cycles(n), 1e-9)))


def _cost_based_diag(m: int, n: int) -> int:
    """Marginal break-even count for lifting one DIAGONAL: the tiled DIA
    kernel adds ~``2*M*n/2048`` VPU FMA cycles + an ``M*4``-byte dvals read
    per diagonal (clustered offsets share the B window, so the window
    traffic is not marginal). Circuit/stencil bands of many ~3%-dense
    diagonals clear this easily where the old fixed 15% rule rejected
    them (round-3: scircuit-class)."""
    dia_cycles = 2.0 * m * n / 2048.0 + m * 4 / BYTES_PER_CYCLE
    return max(4, int(dia_cycles / max(_residue_edge_cycles(n), 1e-9)))


@timed("pack_s")
def split_structure(
    coo: COOMatrix,
    *,
    n: Optional[int] = None,
    diag_min_density: float = 0.15,
    max_diags: int = 48,
    head_min_degree_frac: float = 0.004,
    max_head_cols: int = 2048,
    min_head_cols: int = 32,
    row_min_degree_frac: float = 0.004,
    max_head_rows: int = 256,
    min_head_rows: int = 8,
) -> HybridSplit:
    """Decompose ``coo`` into diagonals + dense head columns + residue.

    Selection heuristics (cost-motivated):

    * a diagonal is lifted when it holds >= ``diag_min_density * m``
      nonzeros — below that, the (M, N) elementwise pass costs more memory
      traffic than the nonzeros justify;
    * a column is lifted into the head when it pays: with ``n`` given, the
      threshold is the *marginal break-even degree* — the dense MXU strip
      costs ``2*M*n/10k + M*4/BW`` cycles vs ~``deg * edge-kernel
      per-edge`` cycles in the residue (round-3 widening: on webgraph-class
      at N=512 this lifts columns down to degree ~125 where the old fixed
      0.4%% rule stopped at 400). Without ``n``, the fixed
      ``head_min_degree_frac * m`` rule applies. Either way the head is
      capped at ``max_head_cols`` densest columns (M x H x 4 bytes);
    * everything else is the residue, in ORIGINAL coordinates (no global
      permutation: B is only gathered for the head's H rows).
    """
    m, k = coo.shape
    rows = coo.rows.astype(np.int64)
    cols = coo.cols.astype(np.int64)
    vals = coo.vals
    n_edges = rows.size

    taken = np.zeros(n_edges, dtype=bool)

    # --- diagonals ---
    d = cols - rows  # in [-(m-1), k-1]
    dmin = int(d.min(initial=0))
    counts = np.bincount((d - dmin).astype(np.int64))
    if n is not None:
        thresh = _cost_based_diag(m, n)
        # dvals is (D, m) dense: cap its footprint at ~1.5 GB
        max_diags = min(max(max_diags, 256),
                        max(8, int(1.5e9 / max(4 * m, 1))))
    else:
        thresh = max(1, int(diag_min_density * min(m, k)))
    cand = np.flatnonzero(counts >= thresh)
    order = np.argsort(-counts[cand], kind="stable")
    cand = cand[order[:max_diags]]
    diag_offsets = np.sort(cand + dmin)
    if diag_offsets.size:
        on_diag = np.isin(d, diag_offsets)
        taken |= on_diag
        diag_vals = np.zeros((diag_offsets.size, m), dtype=np.float32)
        off_index = {int(c): i for i, c in enumerate(diag_offsets)}
        dsel = np.flatnonzero(on_diag)
        didx = np.fromiter(
            (off_index[int(x)] for x in d[dsel]), count=dsel.size, dtype=np.int64
        )
        np.add.at(diag_vals, (didx, rows[dsel]), vals[dsel])
    else:
        diag_vals = np.zeros((0, m), dtype=np.float32)

    # --- dense head columns (degree computed on what's left) ---
    rem = ~taken
    deg = np.bincount(cols[rem], minlength=k)
    # absolute floor: a column below ~4 nnz never beats the residue
    if n is not None:
        deg_thresh = _cost_based_degree(k, n, length=m)
    else:
        deg_thresh = max(4, int(head_min_degree_frac * m))
    head_cols = np.flatnonzero(deg >= deg_thresh)
    # memory cap: the dense head costs M x H x 4 bytes on host AND device —
    # bound it at ~1.5 GB so 1M-row matrices cannot blow up under the
    # cost-widened threshold
    max_head_eff = min(max_head_cols, max(min_head_cols,
                                          int(1.5e9 / max(4 * m, 1))))
    if head_cols.size > max_head_eff:
        top = np.argsort(-deg[head_cols], kind="stable")[:max_head_eff]
        head_cols = np.sort(head_cols[top])
    if head_cols.size < min_head_cols:
        head_cols = np.zeros(0, dtype=np.int64)
    if head_cols.size:
        in_head = np.zeros(k, dtype=bool)
        in_head[head_cols] = True
        on_head = rem & in_head[cols]
        taken |= on_head
        col_rank = np.zeros(k, dtype=np.int64)
        col_rank[head_cols] = np.arange(head_cols.size)
        head_dense = np.zeros((m, head_cols.size), dtype=np.float32)
        hsel = np.flatnonzero(on_head)
        np.add.at(head_dense, (rows[hsel], col_rank[cols[hsel]]), vals[hsel])
    else:
        head_dense = np.zeros((m, 0), dtype=np.float32)

    # --- dense head rows (hub rows — circuit nets, supernode rows) ---
    rem = ~taken
    rdeg = np.bincount(rows[rem], minlength=m)
    if n is not None:
        rdeg_thresh = _cost_based_degree(m, n, length=k)
    else:
        rdeg_thresh = max(4, int(row_min_degree_frac * k))
    head_rows = np.flatnonzero(rdeg >= rdeg_thresh)
    if head_rows.size > max_head_rows:
        top = np.argsort(-rdeg[head_rows], kind="stable")[:max_head_rows]
        head_rows = np.sort(head_rows[top])
    if head_rows.size < min_head_rows:
        head_rows = np.zeros(0, dtype=np.int64)
    if head_rows.size:
        in_hrow = np.zeros(m, dtype=bool)
        in_hrow[head_rows] = True
        on_hrow = rem & in_hrow[rows]
        taken |= on_hrow
        row_rank = np.zeros(m, dtype=np.int64)
        row_rank[head_rows] = np.arange(head_rows.size)
        head_rows_dense = np.zeros((head_rows.size, k), dtype=np.float32)
        rsel_ = np.flatnonzero(on_hrow)
        np.add.at(head_rows_dense, (row_rank[rows[rsel_]], cols[rsel_]), vals[rsel_])
    else:
        head_rows_dense = np.zeros((0, k), dtype=np.float32)

    # --- residue ---
    rsel = np.flatnonzero(~taken)
    residue = COOMatrix(
        (m, k),
        coo.rows[rsel],
        coo.cols[rsel],
        coo.vals[rsel],
    )
    return HybridSplit(
        m=m,
        k=k,
        nnz=coo.nnz,
        diag_offsets=diag_offsets.astype(np.int64),
        diag_vals=diag_vals,
        head_cols=head_cols.astype(np.int32),
        head_dense=head_dense,
        head_rows=head_rows.astype(np.int32),
        head_rows_dense=head_rows_dense,
        residue=residue,
    )


# "pallas": the DIA kernels (their plain version on CPU tensors); "xla": the
# plain PyTorch version on any device. The JAX package's names.
def check_split(split) -> None:
    """Shapes and indices of a hybrid split, checked once on the host before
    upload: the plan gathers B rows at ``head_cols`` and adds into C rows at
    ``head_rows``, and a diagonal must cross A."""
    m, k = split.m, split.k
    offs, rows = np.asarray(split.diag_offsets), np.asarray(split.head_rows)
    cols = np.asarray(split.head_cols)
    shapes = {"diag_vals": (offs.size, m), "head_dense": (m, cols.size),
              "head_rows_dense": (rows.size, k)}
    for name, shape in shapes.items():
        if np.shape(getattr(split, name)) != shape:
            raise ValueError(f"{name} must be {shape}, got {np.shape(getattr(split, name))}")
    if offs.ndim != 1 or cols.ndim != 1 or rows.ndim != 1:
        raise ValueError("diag_offsets, head_cols and head_rows must be 1-D")
    if tuple(split.residue.shape) != (m, k):
        raise ValueError(f"the residue must be ({m}, {k}), got {tuple(split.residue.shape)}")
    if offs.size and (np.any(np.diff(offs) <= 0) or offs[0] <= -m or offs[-1] >= k):
        raise ValueError(f"diag_offsets must ascend strictly within ({-m}, {k})")
    if cols.size and (cols.min() < 0 or cols.max() >= k):
        raise ValueError(f"head_cols holds a column outside [0, k={k})")
    if rows.size and (np.any(np.diff(rows) <= 0) or rows[0] < 0 or rows[-1] >= m):
        raise ValueError(f"head_rows must ascend strictly within [0, m={m})")


def _count_split(split) -> None:
    """Counts the split's parts once a split, however many plans share it:
    ``hybrid.diag_entries`` and ``hybrid.diag_slots`` (the nonzeros of
    ``diag_vals``, and D x M), ``hybrid.dense_entries`` and
    ``hybrid.dense_slots`` (the nonzeros of the head columns' and hub rows'
    planes, and M x H + R x K), and ``hybrid.residue_entries``."""
    if split.__dict__.get("_counted"):
        return
    split.__dict__["_counted"] = True
    count("hybrid.diag_entries", split.diag_nnz)
    count("hybrid.diag_slots", int(np.size(split.diag_vals)))
    count("hybrid.dense_entries", split.head_nnz + split.head_row_nnz)
    count("hybrid.dense_slots", int(np.size(split.head_dense) + np.size(split.head_rows_dense)))
    count("hybrid.residue_entries", split.residue.nnz)


DIA_BACKENDS = ("auto", "pallas", "xla")


class HybridSpmmPlan:
    """Executor for a :class:`HybridSplit` at a fixed N on one device::

        C' = residue(B, C_in = beta*C + alpha*(diag + head + hub-row parts))

    with the residue's plan run at beta = 1. The same ``__call__`` /
    ``repeat`` surface as :class:`~sextans_tpu_torch.ops.plan.SpmmPlan`.

    ``device`` is explicit. ``dia_backend="auto"`` is ``"pallas"`` on a CUDA
    device (the DIA kernel: K7 ``spmm_dia_skinny`` for N <= 32, else K6
    ``spmm_dia``) and ``"xla"`` (the plain version) on the CPU.

    The residue is packed by ``ops/plan.py:FORMATS[residue_fmt]`` (``vpu``,
    ``mxu``, ``edge``, ``ell``) or, without ``residue_fmt``, by the packer of
    ``backend`` (``ops/plan.py:FORMAT_OF``), with ``residue_config``,
    and run by ``SpmmPlan(packed, n, backend)``. An empty residue is skipped
    and needs none of the three. The JAX package picks the residue's format
    and config with ``choose_backend`` from TPU cycle models; that choice is
    not ported (ROADMAP.md queue 1 item 6), so a non-empty residue without
    ``residue_fmt`` or a concrete ``backend``, or without ``residue_config``,
    raises ``ValueError``.

    ``pack_cache`` and ``cache_name`` route the residue's pack through a
    :class:`~sextans_tpu_torch.format.pack_cache.PackCache`, as the JAX
    plan does; ``cache_name`` names the residue (e.g.
    ``f"{matrix}@n{n}-residue"``), and the cache's content fingerprint keeps
    a reused name from aliasing another residue.

    The head columns and hub rows: on the ``"pallas"`` route by the
    row-sparse pass over their entries (``ops/hybrid_hub.py``; the plain
    version on the CPU), with no dense plane on the device: on the plain
    step one pass adds them into the DIA kernel's output in place
    (``launch.hybrid_hub`` once a step on a card), on the precise step two
    compensated passes at alpha = 1 into zeros, one a part; on the
    ``"xla"`` route the dense planes and two f32 matmuls, as in the JAX
    package.

    ``precise`` 1 or 2 is the JAX package's precise composition: the
    residue is packed at that level (where its config has none) and run
    with no C at alpha = 1; the DIA part runs compensated (K6 or K7, or
    their plain version for ``dia_backend="xla"``) at alpha = 1; the head
    columns' and hub rows' sums are compensated too on ``"pallas"`` (the
    hub pass at the plan's level), and stay plain f32 matmuls on ``"xla"``,
    as in the JAX package; and ``beta * C`` and ``alpha`` times each part
    are summed with ``two_prod``/``two_sum``, their errors carried beside,
    and rounded once.
    """

    def __init__(
        self,
        split: HybridSplit,
        n: int,
        *,
        residue_config: Optional[SpmmConfig] = None,
        residue_fmt: Optional[str] = None,
        backend: str = "auto",
        dia_backend: str = "auto",
        pack_cache=None,
        cache_name: Optional[str] = None,
        precise: int = 0,
        device,
    ):
        if int(precise) not in (0, 1, 2):
            raise ValueError(f"precise must be 0, 1 or 2, got {precise}")
        if n < 1:
            raise ValueError(f"N must be positive, got {n}")
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; expected one of {BACKENDS}")
        if residue_fmt is not None and residue_fmt not in FORMATS:
            raise ValueError(f"unknown residue_fmt {residue_fmt!r}; expected one of "
                             f"{tuple(FORMATS)}")
        if dia_backend not in DIA_BACKENDS:
            raise ValueError(f"unknown dia_backend {dia_backend!r}; expected one of "
                             f"{DIA_BACKENDS}")
        check_split(split)
        self.split = split
        self.m, self.k = split.m, split.k
        self.n = n
        self.precise = int(precise)
        self.device = resolve_device(device)
        if dia_backend == "auto":
            dia_backend = "pallas" if self.device.type == "cuda" else "xla"
        self.dia_backend = dia_backend

        self.residue_plan = None
        if split.residue.nnz > 0:
            if residue_fmt is None and backend != "auto":
                residue_fmt = FORMAT_OF[backend]
            if residue_fmt is None:
                raise ValueError(
                    f"the residue holds {split.residue.nnz} nonzeros and neither "
                    "residue_fmt nor a backend names its format; the JAX package's "
                    "choice (choose_backend) is not ported: ROADMAP.md queue 1 item 6"
                )
            if residue_config is None:
                raise ValueError(
                    f"the residue holds {split.residue.nnz} nonzeros and no "
                    "residue_config is given; the JAX package packs it with the config "
                    "of choose_backend, which is not ported: ROADMAP.md queue 1 item 6"
                )
            cfg = residue_config
            if self.precise and not cfg.precise:
                cfg = cfg.with_(precise=self.precise)
            if pack_cache is not None and cache_name is not None:
                # the cache keys on the pack's fields only: a precise variant
                # shares the plain pack's arrays and its upload
                packed = pack_cache.get_or_pack(cache_name, split.residue, cfg, residue_fmt)
            else:
                packed = FORMATS[residue_fmt](split.residue, cfg)
            self.residue_plan = SpmmPlan(packed, n, backend, device=self.device)

        self._upload(split, n, dia_backend)

    @timed("upload_s")
    def _upload(self, split: HybridSplit, n: int, dia_backend: str) -> None:
        """Device copies of the split's diagonals (with K6's or K7's run
        plan, and K6's entry map where its walk pays,
        ``ops/spmm_dia.py:entry_walk_slots``: counted as ``dia.walk_entries``
        once a plan) and of its head columns and hub rows: on the ``"pallas"``
        route their lists (``ops/hybrid_hub.py:hub_lists``: one for the plain
        step, one a part for the precise one; counted as
        ``hybrid.hub_entries`` and ``hybrid.hub_rows`` once a plan), on
        ``"xla"`` their dense planes. Counts the split once."""
        _count_split(split)
        self._dvals = self._offsets = self._dia = self._runs = None
        self._dia_kw = {}
        if split.diag_offsets.size:
            self._dvals = put(split.diag_vals, np.float32, self.device)
            self._offsets = put(split.diag_offsets, np.int32, self.device)
            self._dia = (spmm_dia_ref if dia_backend == "xla"
                         else spmm_dia_skinny if n <= SKINNY_MAX_N else spmm_dia)
            if self._dia is not spmm_dia_ref:  # K6, K7: the offsets in runs, planned once
                self._runs = dia_plan(split.diag_offsets, self.device)
                self._offsets = self._runs.offsets
                self._dia_kw = {"runs": self._runs}
            if self._dia is spmm_dia:  # K6 walks the entries alone where that pays
                walk = dia_entries(self._dvals, self._offsets, split.diag_vals,
                                   within=entry_walk_slots(split.diag_offsets, split.m,
                                                           self.precise))
                if walk is not None:
                    self._dia_kw["entries"] = walk
                    count("dia.walk_entries", walk.entries)
        self._head = self._head_cols = self._hrows = self._hrows_idx = None
        self._hub = self._head_hub = self._row_hub = None
        if dia_backend == "pallas":  # the row-sparse pass, no planes
            r, none = split.head_rows.size, np.zeros(0, dtype=np.int64)
            if not self.precise:  # both parts in one pass, in place in the step's output
                if split.head_cols.size or r:
                    self._hub = hub_lists(split.head_cols, split.head_dense, split.head_rows,
                                          split.head_rows_dense, self.device)
            else:  # each part on its own: the head columns' (M, N), the hub rows' (R, N)
                if split.head_cols.size:
                    self._head_hub = hub_lists(split.head_cols, split.head_dense, none,
                                               np.zeros((0, split.k), np.float32), self.device)
                if r:
                    self._row_hub = hub_lists(none, np.zeros((r, 0), np.float32),
                                              np.arange(r), split.head_rows_dense, self.device)
                    self._hrows_idx = put(split.head_rows, np.int64, self.device)
            for lists in self.hub_passes:
                count("hybrid.hub_entries", lists.entries)
                count("hybrid.hub_rows", lists.jobs)
            return
        if split.head_cols.size:
            self._head = put(split.head_dense, np.float32, self.device)
            self._head_cols = put(split.head_cols, np.int64, self.device)
        if split.head_rows.size:
            self._hrows = put(split.head_rows_dense, np.float32, self.device)
            self._hrows_idx = put(split.head_rows, np.int64, self.device)

    @property
    def hub_passes(self) -> tuple:
        """The hub lists the plan's steps pass over (``ops/hybrid_hub.py``):
        one for the plain ``"pallas"`` step, the head columns' and the hub
        rows' apart for the precise one, none on the ``"xla"`` route."""
        return tuple(h for h in (self._hub, self._head_hub, self._row_hub) if h is not None)

    @property
    def nbytes(self) -> int:
        """Bytes the plan keeps on its device: the split's diagonals, its
        hub lists or dense planes, and the residue's pack."""
        walk = self._dia_kw.get("entries")
        parts = [self._dvals, self._offsets, self._head, self._head_cols, self._hrows,
                 self._hrows_idx, self._runs and self._runs.ptr,
                 *((walk.runs.ptr, walk.order, walk.slot_ptr, walk.slots) if walk else ()),
                 *(t for lists in self.hub_passes for t in lists.arrays)]
        if self.residue_plan is not None:
            parts += [*self.residue_plan.arrays, *(self.residue_plan.ranges or ()),
                      self.residue_plan.image]
        return sum(t.nbytes for t in parts if isinstance(t, torch.Tensor))

    def _operands(self, b, beta, c):
        b = dense_operand(b, (self.k, self.n), "B", self.device).contiguous()
        if c is None:
            if float(beta) != 0.0:
                raise ValueError("beta != 0 requires an input C")
            return b, None
        return b, dense_operand(c, (self.m, self.n), "C", self.device).contiguous()

    def _step(self, b, c, alpha, beta) -> torch.Tensor:
        """One hybrid step; ``c`` None is the no-C path (beta = 0)."""
        if self.precise:
            return self._precise_step(b, c, alpha, beta)
        with_c = c is not None
        if self._dia is not None:
            c_in = c if with_c else torch.zeros(1, device=self.device).expand(self.m, self.n)
            acc = self._dia(self._dvals, self._offsets, b, c_in, alpha, beta, with_c=with_c,
                            **self._dia_kw)
        elif with_c:
            acc = c * f32(beta)
        else:
            acc = torch.zeros((self.m, self.n), dtype=torch.float32, device=self.device)
        with annotate("sx.hybrid.dense", self.device):
            acc = self._add_hubs(acc, b, alpha)
        if self.residue_plan is not None:
            acc = self.residue_plan(b, alpha, 1.0, acc)
        return acc

    def _hub_parts(self, b):
        """The head columns' (M, N) and the hub rows' (R, N) products at
        alpha = 1, each on its own, None where the split has none: on the
        ``"pallas"`` route the row-sparse pass into zeros at the plan's
        precise level (a compensated sum, rounded once), on ``"xla"`` the
        planes' f32 matmuls."""
        head = hrows = None
        if self._head_hub is not None:
            head = hybrid_hub(torch.zeros((self.m, self.n), dtype=torch.float32,
                                          device=self.device), b, 1.0, self._head_hub,
                              self.precise)
        elif self._head is not None:
            with no_tf32():
                head = torch.matmul(self._head, b[self._head_cols])
        if self._row_hub is not None:
            hrows = hybrid_hub(torch.zeros((self._row_hub.m, self.n), dtype=torch.float32,
                                           device=self.device), b, 1.0, self._row_hub,
                               self.precise)
        elif self._hrows is not None:
            with no_tf32():
                hrows = torch.matmul(self._hrows, b)
        return head, hrows

    def _add_hubs(self, acc, b, alpha) -> torch.Tensor:
        """The plain step's hub parts, ``acc + alpha * (head + hub rows)``:
        on the ``"pallas"`` route one row-sparse pass in place (``acc`` is
        never the caller's C), on ``"xla"`` the planes' products added in the
        JAX package's order. Returns the sum."""
        if self._hub is not None:
            return hybrid_hub(acc, b, alpha, self._hub)
        head, hrows = self._hub_parts(b)
        if head is not None:
            acc = acc + f32(alpha) * head
        if hrows is not None:
            # head rows are unique, so this adds deterministically
            acc.index_add_(0, self._hrows_idx, f32(alpha) * hrows)
        return acc

    def _precise_step(self, b, c, alpha, beta) -> torch.Tensor:
        """The precise step, in the JAX package's order (its hybrid.py,
        ``one_step`` of the precise branch): ``acc, resid = two_prod(beta,
        C)``, then for the DIA, head, hub-row and residue parts in turn
        ``p, pe = two_prod(alpha, part)``, ``acc, e = two_sum(acc, p)`` and
        ``resid += pe + e``; returns ``acc + resid``. Every op is a separate
        elementwise PyTorch op, rounded once: nothing here may fuse a
        multiply into an add (``addcmul``, ``add(alpha=)``), or ``two_sum``
        breaks."""
        a = torch.tensor(f32(alpha), dtype=torch.float32, device=self.device)
        if c is None:
            acc = torch.zeros((self.m, self.n), dtype=torch.float32, device=self.device)
            resid = torch.zeros_like(acc)
        else:
            acc, resid = two_prod(torch.tensor(f32(beta), dtype=torch.float32,
                                               device=self.device), c)

        def add(part):
            nonlocal acc, resid
            p, pe = two_prod(a, part)
            acc, e = two_sum(acc, p)
            resid = resid + (pe + e)

        if self._dia is not None:
            shape = torch.zeros(1, device=self.device).expand(self.m, self.n)
            add(self._dia(self._dvals, self._offsets, b, shape, 1.0, 0.0, with_c=False,
                          precise=1, **self._dia_kw))
        with annotate("sx.hybrid.dense", self.device):
            head, hrows = self._hub_parts(b)
            if head is not None:
                add(head)
            if hrows is not None:
                # head rows are unique: set their sums, add their errors
                p, pe = two_prod(a, hrows)
                s, e = two_sum(acc[self._hrows_idx], p)
                acc = acc.index_copy(0, self._hrows_idx, s)
                resid = resid.index_add(0, self._hrows_idx, pe + e)
        if self.residue_plan is not None:
            add(self.residue_plan(b, 1.0))
        return acc + resid

    def __call__(self, b, alpha=1.0, beta=0.0, c=None) -> torch.Tensor:
        """``alpha * A @ b + beta * c`` (M, N), inside the span
        ``sx.hybrid.call``; counts ``hybrid.calls``."""
        with annotate("sx.hybrid.call"):
            count("hybrid.calls")
            b, c = self._operands(b, beta, c)
            return self._step(b, c, alpha, beta)

    def repeat(self, b, alpha=1.0, beta=0.0, c=None, times: int = 1) -> torch.Tensor:
        """The whole hybrid step ``times`` times on the current stream, C fed
        back each time (the reference's rp_time loop); each step a span
        ``sx.hybrid.call`` and a count of ``hybrid.calls``."""
        b, c = self._operands(b, beta, c)
        if c is None:
            c = torch.zeros((self.m, self.n), dtype=torch.float32, device=self.device)
        for _ in range(times):
            with annotate("sx.hybrid.call"):
                count("hybrid.calls")
                c = self._step(b, c, alpha, beta)
        return c
