"""Row-block partitioning of a sparse matrix across devices.

A copy of ``sextans_tpu.parallel.partition`` (host NumPy code), held
byte-identical to it by ``tests/test_torch_host.py``; serving pads packs with
its ``_pad_shard_groups`` (ops/serve.py). ``pack_sharded_auto`` is not
copied: it needs the JAX package's ``ici_model``, whose port comes with the
sharded plans. Its design notes:

The reference's parallel memory system is 29 dedicated HBM channels on one
FPGA (link_config.ini:2-34). The TPU-native rebirth of that bandwidth
parallelism is *chip* parallelism (SURVEY.md §2.4): A and C are 1-D
row-block sharded over a device mesh, B is replicated, and each chip runs
the single-chip kernel on its row slab — no cross-chip communication is
needed for the row-sharded formulation (C rows live where A rows live).

``pack_sharded`` splits the rows into ``n_shards`` equal padded slabs, packs
each independently, then pads every shard's group count to the common max so
the stacked arrays are SPMD-uniform. Padding groups *extend the last real
group run* of each shard (same m-tile, zero values) so the kernel's
first/last-group epilogue logic is untouched.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from sextans_tpu_torch.format.coo import COOMatrix
from sextans_tpu_torch.format.pack import PackedSpMatrix, pack
from sextans_tpu_torch.format.pack_mxu import pack_mxu
from sextans_tpu_torch.utils.config import SpmmConfig, cdiv, round_up

__all__ = ["ShardedSpMatrix", "pack_sharded", "pack_sharded_k"]


@dataclass
class ShardedSpMatrix:
    """Stacked per-device packed shards (leading axis = device)."""

    m: int  # global rows
    k: int
    nnz: int
    config: SpmmConfig
    n_shards: int
    m_local: int  # padded rows per shard
    n_mtiles_local: int
    n_kwins: int
    # stacked arrays, leading axis n_shards:
    vals: np.ndarray  # (S, ngroups, 8, G*bk) vpu / (S, ngroups, G*bk, 128) mxu
    qrow: np.ndarray  # (S, ngroups, G)
    bcol: np.ndarray  # (S, ngroups, G)
    group_mtile: np.ndarray  # (S, ngroups+1)
    group_kwin: np.ndarray  # (S, ngroups)
    shards: List[PackedSpMatrix]  # per-shard metadata (pre-padding)
    mode: str = "row"  # "row" = row-block sharded; "col" = K-sharded
    # packed format family: "vpu" (8xBK blocks; qrow = stripe index) or
    # "mxu" (BKx128 slabs; qrow holds the slab index qm)
    fmt: str = "vpu"
    # nnz-balanced row mode: tile_assign[s, j] = global m-tile owned by
    # shard s at local position j (None = contiguous slabs). The TPU mesh
    # analog of the reference's row%64 PE interleave
    # (src/sparse_helper.h:370): tiles are LPT-assigned by nnz so no shard
    # becomes the straggler on power-law matrices.
    tile_assign: Optional[np.ndarray] = None
    shard_nnz: Optional[np.ndarray] = None  # (S,) nnz per shard

    @property
    def nnz_imbalance(self) -> float:
        """max/mean per-shard nnz — 1.0 is perfect balance; the mesh runs
        at the slowest shard's pace, so this is the multi-chip efficiency
        ceiling's inverse."""
        if self.shard_nnz is None or self.shard_nnz.sum() == 0:
            return 1.0
        return float(self.shard_nnz.max() / max(self.shard_nnz.mean(), 1e-9))

    @property
    def m_padded(self) -> int:
        """Global padded M."""
        return self.n_shards * self.m_local if self.mode == "row" else self.m_local

    @property
    def k_padded(self) -> int:
        """Per-shard padded K (equals global padded K in row mode)."""
        return self.n_kwins * self.config.window_k

    @property
    def k_padded_global(self) -> int:
        return self.k_padded * (self.n_shards if self.mode == "col" else 1)

    @property
    def n_groups(self) -> int:
        return int(self.group_kwin.shape[1])


def _q_of(p):
    if hasattr(p, "meta"):  # edge format: the meta array rides the qrow slot
        return p.meta
    return p.qm if hasattr(p, "qm") else p.qrow


def _bcol_of(p):
    # edge format has no bcol array; a 1-int placeholder keeps the stacked
    # 5-array plumbing uniform (mirrors SpmmPlan._dev)
    if hasattr(p, "meta"):
        return np.zeros(1, np.int32)
    return p.bcol


def _pad_shard_groups(p, ngroups: int):
    """Extend a shard to ``ngroups`` groups with zero-value padding groups
    that continue the last real group's m-tile run (format-agnostic)."""
    from sextans_tpu_torch.format.pack_edge import PackedSpMatrixEdge

    if isinstance(p, PackedSpMatrixEdge):
        return _pad_shard_chunks_edge(p, ngroups)
    cur = p.n_groups
    if cur == ngroups:
        return p
    extra = ngroups - cur
    G = p.config.group_blocks
    last_mt = p.group_mtile[cur - 1]
    vals = np.concatenate(
        [p.vals, np.zeros((extra,) + p.vals.shape[1:], dtype=np.float32)],
        axis=0,
    )
    qrow = np.concatenate([_q_of(p), np.zeros((extra, G), dtype=np.int32)], axis=0)
    bcol = np.concatenate([p.bcol, np.zeros((extra, G), dtype=np.int32)], axis=0)
    group_kwin = np.concatenate(
        [p.group_kwin, np.zeros(extra, dtype=np.int32)], axis=0
    )
    group_mtile = np.concatenate(
        [
            p.group_mtile[:cur],
            np.full(extra, last_mt, dtype=np.int32),
            np.array([-1], dtype=np.int32),
        ]
    )
    kw = dict(
        m=p.m,
        k=p.k,
        nnz=p.nnz,
        config=p.config,
        n_mtiles=p.n_mtiles,
        n_kwins=p.n_kwins,
        vals=vals,
        bcol=bcol,
        group_mtile=group_mtile,
        group_kwin=group_kwin,
        stats=p.stats,
        # padding does not touch the column/row space — a degree-reordered
        # pack keeps its permutations (dropping them here would silently
        # misalign B/C against the packed A)
        col_perm=p.col_perm,
        row_perm=getattr(p, "row_perm", None),
    )
    if hasattr(p, "qm"):
        from sextans_tpu_torch.format.pack_mxu import PackedSpMatrixMXU

        return PackedSpMatrixMXU(qm=qrow, **kw)
    return PackedSpMatrix(qrow=qrow, **kw)


def _pad_shard_chunks_edge(p, nchunks: int):
    """Edge-format twin of _pad_shard_groups: all-padding chunks (zero vals,
    zero meta — no row_end, so the register carry never flushes) extending
    the last chunk's m-tile run."""
    from sextans_tpu_torch.format.pack_edge import PackedSpMatrixEdge

    cur = p.n_chunks
    if cur == nchunks:
        return p
    extra = nchunks - cur
    E = p.config.edge_chunk
    last_mt = p.chunk_mtile[cur - 1]
    return PackedSpMatrixEdge(
        m=p.m, k=p.k, nnz=p.nnz, config=p.config,
        n_mtiles=p.n_mtiles, n_kwins=p.n_kwins,
        vals=np.concatenate(
            [p.vals, np.zeros((extra, 1, E), np.float32)], axis=0
        ),
        meta=np.concatenate(
            [p.meta, np.zeros((extra, 1, E), np.int32)], axis=0
        ),
        chunk_mtile=np.concatenate([
            p.chunk_mtile[:cur],
            np.full(extra, last_mt, dtype=np.int32),
            np.array([-1], dtype=np.int32),
        ]),
        chunk_kwin=np.concatenate(
            [p.chunk_kwin, np.zeros(extra, dtype=np.int32)]
        ),
        stats=p.stats,
        col_perm=p.col_perm,
    )


def _pack_fmt(local, config, fmt):
    if fmt == "mxu":
        return pack_mxu(local, config)
    if fmt == "edge":
        from sextans_tpu_torch.format.pack_edge import pack_edge

        return pack_edge(local, config)
    if fmt == "ell":
        from sextans_tpu_torch.format.pack_ell import pack_ell

        # no per-shard inflation gate: a skewed matrix that packs fine
        # globally must not fail because THIS shard's slab is nearly empty
        # — pack_sharded/pack_sharded_k enforce the gate once on the
        # global (or joint per-shard) degree histogram before packing
        return pack_ell(local, config, max_bytes_per_nnz=float("inf"))
    return pack(local, config)


def _pad_shard_ell(p, m_padded: int, n_virt: int):
    """ELL twin of _pad_shard_groups: grow the slot grid with zero-slot rows
    and the fold table with entries pointing at those zero rows (their
    scatter-adds contribute exact zeros), so stacked shards are
    SPMD-uniform."""
    from sextans_tpu_torch.format.pack_ell import PackedSpMatrixELL

    extra_rows = m_padded - p.m_padded
    pad_fold = n_virt - p.n_virt
    if extra_rows == 0 and pad_fold == 0:
        return p
    # keep fold_rows sorted (engine passes indices_are_sorted=True): repeat
    # the last real target, or row 0 when the shard has no virtual rows
    fill = int(p.fold_rows[-1]) if p.n_virt else 0
    return PackedSpMatrixELL(
        m=p.m, k=p.k, nnz=p.nnz, config=p.config,
        slots_per_row=p.slots_per_row, m_base=p.m_base,
        cols=np.pad(p.cols, ((0, extra_rows), (0, 0))),
        vals=np.pad(p.vals, ((0, extra_rows), (0, 0))),
        fold_rows=np.concatenate(
            [p.fold_rows, np.full(pad_fold, fill, np.int32)]
        ),
        stats=p.stats,
    )


def pack_sharded_k(
    coo: COOMatrix, n_shards: int, config: SpmmConfig = SpmmConfig(),
    fmt: str = "vpu",
) -> ShardedSpMatrix:
    """Split *columns* into ``n_shards`` slabs (K-sharded A, for the
    reduce-scatter formulation). Every shard covers the full (padded) row
    range; ``m_local`` here is the full padded M, rounded so the
    reduce-scatter chunk (m_padded / n_shards) is whole."""
    m, k = coo.shape
    wk, tm = config.window_k, config.tile_m
    k_local = round_up(cdiv(max(k, 1), n_shards), wk)
    # full-M rows on every shard; M padded so n_shards divides it
    m_round = round_up(max(m, 1), tm * n_shards)

    if fmt == "ell":
        # pin a single slots-per-row from the union of PER-SHARD degree
        # histograms (each shard sees only its K slab of every row), and
        # apply the inflation gate ONCE on that joint histogram — the
        # per-shard packs run ungated (an empty K slab must not reject a
        # matrix that packs fine jointly)
        from sextans_tpu_torch.format.pack_ell import (
            check_ell_inflation,
            choose_slots_per_row,
        )

        shard_of = np.minimum(coo.cols.astype(np.int64) // k_local,
                              n_shards - 1)
        joint_deg = np.bincount(
            shard_of * m_round + coo.rows.astype(np.int64),
            minlength=m_round * n_shards,
        )
        if config.ell_r is None:
            joint = COOMatrix(
                (m_round * n_shards, 1),
                (shard_of * m_round + coo.rows).astype(np.int64),
                np.zeros(coo.nnz, np.int64),
                np.ones(coo.nnz, np.float32),
            )
            config = config.with_(ell_r=choose_slots_per_row(joint))
        check_ell_inflation(
            joint_deg, config.ell_r, coo.nnz, pad_rows=n_shards * tm
        )

    shards: List[PackedSpMatrix] = []
    for s in range(n_shards):
        lo, hi = s * k_local, min((s + 1) * k_local, k)
        if lo >= k:
            local = COOMatrix(
                (m_round, k_local),
                np.zeros(0, np.int32),
                np.zeros(0, np.int32),
                np.zeros(0, np.float32),
            )
        else:
            sel = (coo.cols >= lo) & (coo.cols < hi)
            local = COOMatrix(
                (m_round, k_local),
                coo.rows[sel],
                coo.cols[sel] - lo,
                coo.vals[sel],
            )
        shards.append(_pack_fmt(local, config, fmt))

    if fmt == "ell":
        m_pad_u = max(p.m_padded for p in shards)
        n_virt_u = max(p.n_virt for p in shards)
        padded = [_pad_shard_ell(p, m_pad_u, n_virt_u) for p in shards]
        ph = np.zeros((n_shards, 1), np.int32)
        return ShardedSpMatrix(
            m=m, k=k, nnz=coo.nnz, config=config, n_shards=n_shards,
            m_local=m_round,
            n_mtiles_local=m_pad_u // tm,
            n_kwins=k_local // wk,
            vals=np.stack([p.vals for p in padded]),
            qrow=np.stack([p.cols for p in padded]),
            bcol=np.stack([p.fold_rows for p in padded]),
            group_mtile=ph,
            group_kwin=ph,
            shards=shards,
            mode="col",
            fmt=fmt,
        )

    ngroups = max(p.n_groups for p in shards)
    padded = [_pad_shard_groups(p, ngroups) for p in shards]
    return ShardedSpMatrix(
        m=m,
        k=k,
        nnz=coo.nnz,
        config=config,
        n_shards=n_shards,
        m_local=m_round,  # full padded M on every shard
        n_mtiles_local=m_round // tm,
        n_kwins=k_local // wk,
        vals=np.stack([p.vals for p in padded]),
        qrow=np.stack([_q_of(p) for p in padded]),
        bcol=np.stack([_bcol_of(p) for p in padded]),
        group_mtile=np.stack([p.group_mtile for p in padded]),
        group_kwin=np.stack([p.group_kwin for p in padded]),
        shards=shards,
        mode="col",
        fmt=fmt,
    )


def _lpt_tile_assign(tile_nnz: np.ndarray, n_shards: int) -> np.ndarray:
    """Greedy LPT assignment of m-tiles to shards, exactly T/S tiles each.

    Tiles sorted by nnz descending; each goes to the currently-lightest
    shard that still has capacity. Equal tile counts keep the stacked
    arrays SPMD-uniform; nnz balance keeps the mesh off the
    slowest-shard wall (the reference balances its 64 PEs the same way,
    by row%64 interleave — src/sparse_helper.h:370)."""
    t_pad = tile_nnz.size
    cap = t_pad // n_shards
    loads = np.zeros(n_shards, dtype=np.int64)
    counts = np.zeros(n_shards, dtype=np.int64)
    assign: List[List[int]] = [[] for _ in range(n_shards)]
    for t in np.argsort(-tile_nnz, kind="stable"):
        open_ = np.flatnonzero(counts < cap)
        s = open_[np.argmin(loads[open_])]
        assign[s].append(int(t))
        loads[s] += int(tile_nnz[t])
        counts[s] += 1
    # ascending tile order inside each shard preserves row locality
    return np.array([sorted(a) for a in assign], dtype=np.int64)


def pack_sharded(
    coo: COOMatrix, n_shards: int, config: SpmmConfig = SpmmConfig(),
    fmt: str = "vpu", balance: str = "contiguous",
) -> ShardedSpMatrix:
    """Split rows into ``n_shards`` equal-size slabs and pack each.

    ``fmt``: packed format family — "vpu" (8xBK blocks), "mxu"
    (BKx128 dense slabs for the systolic-array kernel), or "edge".

    ``balance``: "contiguous" — shard s owns rows [s*m_local, (s+1)*m_local)
    (row-count balanced; on power-law matrices most nnz can land on a few
    shards). "nnz" — m-tiles are LPT-assigned by nonzero count so every
    shard carries ~equal work; the executor permutes C tiles to match
    (``tile_assign``)."""
    if balance not in ("contiguous", "nnz"):
        raise ValueError(f"balance must be 'contiguous' or 'nnz', got {balance!r}")
    m, k = coo.shape
    tm = config.tile_m
    n_kwins = max(1, cdiv(k, config.window_k))
    if fmt == "ell":
        # pin slots-per-row from the GLOBAL degree histogram so every
        # shard's slot grid has the same width (SPMD-uniform stacking),
        # and apply the inflation gate ONCE globally — per-shard packs run
        # ungated (a nearly-empty row slab must not reject a matrix that
        # packs fine globally)
        from sextans_tpu_torch.format.pack_ell import (
            check_ell_inflation,
            choose_slots_per_row,
        )

        if config.ell_r is None:
            config = config.with_(ell_r=choose_slots_per_row(coo))
        check_ell_inflation(
            np.bincount(coo.rows.astype(np.int64), minlength=m),
            config.ell_r, coo.nnz, pad_rows=n_shards * tm,
        )

    tile_assign = None
    if balance == "nnz":
        t_real = max(1, cdiv(m, tm))
        t_pad = round_up(t_real, n_shards)
        t_local = t_pad // n_shards
        m_local = t_local * tm
        tile_nnz = np.bincount(
            coo.rows.astype(np.int64) // tm, minlength=t_pad
        ).astype(np.int64)
        tile_assign = _lpt_tile_assign(tile_nnz, n_shards)
        tile_to_shard = np.empty(t_pad, dtype=np.int64)
        tile_to_pos = np.empty(t_pad, dtype=np.int64)
        for s in range(n_shards):
            tile_to_shard[tile_assign[s]] = s
            tile_to_pos[tile_assign[s]] = np.arange(t_local)
        tile = coo.rows.astype(np.int64) // tm
        edge_shard = tile_to_shard[tile]
        local_rows = (tile_to_pos[tile] * tm + coo.rows % tm).astype(np.int32)
        shard_nnz = np.bincount(edge_shard, minlength=n_shards).astype(np.int64)
    else:
        # Equal per-shard contiguous row slab, multiple of tile_m.
        m_local = round_up(cdiv(max(m, 1), n_shards), tm)
        edge_shard = np.minimum(
            coo.rows.astype(np.int64) // m_local, n_shards - 1
        )
        local_rows = (coo.rows - edge_shard * m_local).astype(np.int32)
        shard_nnz = np.bincount(edge_shard, minlength=n_shards).astype(np.int64)

    shards: List[PackedSpMatrix] = []
    for s in range(n_shards):
        sel = edge_shard == s
        local = COOMatrix(
            (m_local, k),
            local_rows[sel],
            coo.cols[sel],
            coo.vals[sel],
        )
        p = _pack_fmt(local, config, fmt)
        if fmt != "ell":
            assert p.n_kwins == n_kwins and p.n_mtiles == m_local // tm
        shards.append(p)

    if fmt == "ell":
        # ELL gather format: uniform slot grid = max padded rows, fold
        # table padded with zero-contribution entries
        m_pad_u = max(p.m_padded for p in shards)
        n_virt_u = max(p.n_virt for p in shards)
        padded = [_pad_shard_ell(p, m_pad_u, n_virt_u) for p in shards]
        ph = np.zeros((n_shards, 1), np.int32)
        return ShardedSpMatrix(
            m=m, k=k, nnz=coo.nnz, config=config, n_shards=n_shards,
            m_local=m_local,
            n_mtiles_local=m_pad_u // tm,
            n_kwins=n_kwins,
            vals=np.stack([p.vals for p in padded]),
            qrow=np.stack([p.cols for p in padded]),
            bcol=np.stack([p.fold_rows for p in padded]),
            group_mtile=ph,
            group_kwin=ph,
            shards=shards,
            fmt=fmt,
            tile_assign=tile_assign,
            shard_nnz=shard_nnz,
        )

    ngroups = max(p.n_groups for p in shards)
    padded = [_pad_shard_groups(p, ngroups) for p in shards]

    return ShardedSpMatrix(
        m=m,
        k=k,
        nnz=coo.nnz,
        config=config,
        n_shards=n_shards,
        m_local=m_local,
        n_mtiles_local=m_local // tm,
        n_kwins=n_kwins,
        vals=np.stack([p.vals for p in padded]),
        qrow=np.stack([_q_of(p) for p in padded]),
        bcol=np.stack([_bcol_of(p) for p in padded]),
        group_mtile=np.stack([p.group_mtile for p in padded]),
        group_kwin=np.stack([p.group_kwin for p in padded]),
        shards=shards,
        fmt=fmt,
        tile_assign=tile_assign,
        shard_nnz=shard_nnz,
    )
