"""COO-entry → packed-slot maps for value-parameterized SpMM.

The NumPy module ``sextans_tpu.format.slots``, carried over unchanged so
that both packages map each COO entry to the same slot (held byte-identical
by tests/test_torch_slots.py). For the differentiable op (ops/autodiff.py)
A's *values* are an input at each call while A's *structure* stays fixed:
the packed steering arrays (qrow/bcol/meta/group_*) depend only on
coordinates, so a fresh values vector is scattered into the packed ``vals``
buffer on the device:

    packed_vals = zeros(size).index_add_(0, slot_map, coo_vals)

in COO entry order. This module recomputes each format's per-edge
destination (the same arithmetic as the pack passes in pack.py, pack_mxu.py,
pack_edge.py and pack_ell.py); the scatter reproduces ``packed.vals``
bit-exactly for all four formats. Duplicate coordinates sum, matching the
packs' ``np.add.at`` semantics.
"""

from __future__ import annotations

import numpy as np

from sextans_tpu_torch.format.coo import COOMatrix
from sextans_tpu_torch.utils.config import SpmmConfig
from sextans_tpu_torch.utils.profiling import timed

__all__ = ["slot_map"]

MSLAB = 128


@timed("pack_s")
def slot_map(
    coo: COOMatrix, config: SpmmConfig, fmt: str = "vpu",
    reorder_cols: bool = False,
) -> np.ndarray:
    """Flat index into the packed ``vals`` buffer for each COO entry
    (original entry order). ``fmt``: "vpu" | "mxu" | "edge"."""
    if coo.nnz == 0:
        return np.zeros(0, dtype=np.int64)
    if reorder_cols:
        from sextans_tpu_torch.format.pack import reorder_columns

        coo, _ = reorder_columns(coo)
    if fmt == "vpu":
        return _slots_vpu(coo, config)
    if fmt == "mxu":
        return _slots_mxu(coo, config)
    if fmt == "edge":
        return _slots_edge(coo, config)
    if fmt == "ell":
        return _slots_ell(coo, config)
    raise ValueError(f"unknown pack format {fmt!r}")


def _blocks(coo, tm, wk, bk, row_unit):
    """Shared block/job decomposition (mirrors the pack passes)."""
    rows = coo.rows.astype(np.int64)
    cols = coo.cols.astype(np.int64)
    mt = rows // tm
    kwin = cols // wk
    slab = rows // row_unit
    bcb = cols // bk
    order = np.lexsort((bcb, slab, kwin, mt))
    mt_s, kw_s, sl_s, bcb_s = mt[order], kwin[order], slab[order], bcb[order]
    nnz = coo.nnz
    new_blk = np.ones(nnz, dtype=bool)
    if nnz > 1:
        new_blk[1:] = (
            (mt_s[1:] != mt_s[:-1])
            | (kw_s[1:] != kw_s[:-1])
            | (sl_s[1:] != sl_s[:-1])
            | (bcb_s[1:] != bcb_s[:-1])
        )
    blk_of_edge = np.cumsum(new_blk) - 1
    nb = int(blk_of_edge[-1]) + 1
    first = np.flatnonzero(new_blk)
    return order, rows, cols, mt_s, kw_s, sl_s, blk_of_edge, nb, first


def _job_groups(b_mt, b_kw, nb, G):
    new_job = np.ones(nb, dtype=bool)
    if nb > 1:
        new_job[1:] = (b_mt[1:] != b_mt[:-1]) | (b_kw[1:] != b_kw[:-1])
    job_of_blk = np.cumsum(new_job) - 1
    njobs = int(job_of_blk[-1]) + 1
    job_sizes = np.bincount(job_of_blk, minlength=njobs)
    job_groups = -(-job_sizes // G)
    grp_offset = np.zeros(njobs + 1, dtype=np.int64)
    np.cumsum(job_groups, out=grp_offset[1:])
    job_first_pos = np.zeros(njobs + 1, dtype=np.int64)
    np.cumsum(job_sizes, out=job_first_pos[1:])
    return job_of_blk, grp_offset, job_first_pos


def _slots_vpu(coo, config):
    tm, wk, bk, G = (
        config.tile_m, config.window_k, config.block_k, config.group_blocks,
    )
    tmq = tm // 8
    (order, rows, cols, mt_s, kw_s, br_s, blk_of_edge, nb, first) = _blocks(
        coo, tm, wk, bk, row_unit=8
    )
    r_s = (rows & 7)[order]
    j_s = (cols % bk)[order]
    b_mt = mt_s[first]
    b_q = (br_s[first] - b_mt * tmq).astype(np.int64)
    job_of_blk, grp_offset, job_first_pos = _job_groups(
        b_mt, kw_s[first], nb, G
    )

    if config.interleave:
        # round-robin across row stripes (pack.py:351-363)
        runkey_change = np.ones(nb, dtype=bool)
        if nb > 1:
            runkey_change[1:] = (job_of_blk[1:] != job_of_blk[:-1]) | (
                b_q[1:] != b_q[:-1]
            )
        run_id = np.cumsum(runkey_change) - 1
        run_first = np.flatnonzero(runkey_change)
        rank = np.arange(nb) - run_first[run_id]
        sched = np.lexsort((b_q, rank, job_of_blk))
    else:
        sched = np.arange(nb)

    sched_job = job_of_blk[sched]
    pos_in_job = np.arange(nb) - job_first_pos[sched_job]
    dst_group = grp_offset[sched_job] + pos_in_job // G
    dst_slot = pos_in_job % G
    # invert: block id -> (group, slot)
    grp_of_blk = np.empty(nb, dtype=np.int64)
    slot_of_blk = np.empty(nb, dtype=np.int64)
    grp_of_blk[sched] = dst_group
    slot_of_blk[sched] = dst_slot

    blk = blk_of_edge
    flat = (
        grp_of_blk[blk] * (8 * G * bk)
        + r_s * (G * bk)
        + slot_of_blk[blk] * bk
        + j_s
    )
    out = np.empty(coo.nnz, dtype=np.int64)
    out[order] = flat
    return out


def _slots_mxu(coo, config):
    tm, wk, bk, G = (
        config.tile_m, config.window_k, config.block_k, config.group_blocks,
    )
    (order, rows, cols, mt_s, kw_s, ms_s, blk_of_edge, nb, first) = _blocks(
        coo, tm, wk, bk, row_unit=MSLAB
    )
    mm_s = (rows % MSLAB)[order]
    kk_s = (cols % bk)[order]
    job_of_blk, grp_offset, job_first_pos = _job_groups(
        mt_s[first], kw_s[first], nb, G
    )
    # MXU blocks stay in sort order (no interleave pass, pack_mxu.py:290-302)
    pos_in_job = np.arange(nb) - job_first_pos[job_of_blk]
    dst_group = grp_offset[job_of_blk] + pos_in_job // G
    dst_slot = pos_in_job % G

    blk = blk_of_edge
    flat = (
        dst_group[blk] * (G * bk * MSLAB)
        + (dst_slot[blk] * bk + kk_s) * MSLAB
        + mm_s
    )
    out = np.empty(coo.nnz, dtype=np.int64)
    out[order] = flat
    return out


def _slots_ell(coo, config):
    """ELL gather format: slot = ell_row * R + position (pack_ell.py) —
    duplicates keep distinct slots (within-row CSR positions differ)."""
    from sextans_tpu_torch.format.pack_ell import choose_slots_per_row

    m = coo.shape[0]
    r = config.ell_r or choose_slots_per_row(coo)
    order = np.lexsort((coo.cols, coo.rows))
    rows = coo.rows[order].astype(np.int64)
    deg = np.bincount(rows, minlength=m)
    row_start = np.concatenate(([0], np.cumsum(deg)))
    pos = np.arange(coo.nnz, dtype=np.int64) - row_start[rows]
    chunk = pos // r
    n_chunks_per_row = np.maximum(-(-deg // r), (deg > 0).astype(np.int64))
    extra = np.maximum(n_chunks_per_row - 1, 0)
    virt_base = np.concatenate(([0], np.cumsum(extra)))
    ell_rows = np.where(chunk == 0, rows, m + virt_base[rows] + (chunk - 1))
    flat = ell_rows * r + (pos - chunk * r)
    out = np.empty(coo.nnz, dtype=np.int64)
    out[order] = flat
    return out


def _slots_edge(coo, config):
    """Edge format: one slot per edge (pack_edge.py:222-287)."""
    tm, wk, E, L = (
        config.tile_m, config.window_k, config.edge_chunk, config.edge_lanes,
    )
    nnz = coo.nnz
    rows = coo.rows.astype(np.int64)
    cols = coo.cols.astype(np.int64)
    mt = rows // tm
    kwin = cols // wk
    order = np.lexsort((cols, rows, kwin, mt))
    mt_s, kw_s = mt[order], kwin[order]
    rl = (rows % tm)[order]

    new_job = np.ones(nnz, dtype=bool)
    if nnz > 1:
        new_job[1:] = (mt_s[1:] != mt_s[:-1]) | (kw_s[1:] != kw_s[:-1])
    job_of_edge = np.cumsum(new_job) - 1

    new_run = new_job.copy()
    if nnz > 1:
        new_run[1:] |= rl[1:] != rl[:-1]
    run_of_edge = np.cumsum(new_run) - 1
    run_first = np.flatnonzero(new_run)
    n_runs = run_first.size
    run_len = np.diff(np.append(run_first, nnz))
    run_padlen = -(-run_len // L) * L
    run_job = job_of_edge[run_first]

    pad_cum = np.concatenate([[0], np.cumsum(run_padlen)])
    job_first_run_idx = run_of_edge[np.flatnonzero(new_job)]
    job_pad_base = pad_cum[job_first_run_idx]
    run_off_in_job = pad_cum[:n_runs] - job_pad_base[run_job]

    job_padlen = np.concatenate(
        [job_pad_base[1:], [pad_cum[-1]]]
    ) - job_pad_base
    job_chunks = -(-job_padlen // E)
    chunk_of_job = np.concatenate([[0], np.cumsum(job_chunks)])

    idx_in_run = np.arange(nnz, dtype=np.int64) - run_first[run_of_edge]
    dst_in_job = run_off_in_job[run_of_edge] + idx_in_run
    flat = chunk_of_job[job_of_edge] * E + dst_in_job
    out = np.empty(nnz, dtype=np.int64)
    out[order] = flat
    return out
