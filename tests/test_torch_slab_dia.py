"""The host scans and the arithmetic order of the skinny slab kernel (K2) and
the wide DIA kernel (K6), on the CPU.

* ``slab_visits`` lists every block of a slab pack once, under its (M-tile,
  ``qm``) slab, in the order in which K1 (and K2 before it) took them: the
  M-tile's groups as ``group_ranges`` lists them, then the blocks of a
  group; pad groups and empty slabs and M-tiles included.
* A walk of K2's loop over those lists (per block the FFMA chain over kk
  from +0 by ``fma_f32``, then ``acc += cf``, or a Neumaier step after every
  8 terms in precise mode; the kernel's epilogue) gives the same bits as the
  same walk over the M-tile group ranges with the ``qm`` test, with NaN and
  Inf where pad blocks read; it is within 4 ulp of the plain version
  ``spmm_slab_padded_ref`` and of the JAX package's ``mxu_interpret`` route.
* ``dia_runs`` covers every diagonal once, in ascending order, in runs
  whose span is at most the limit, each as long as the limit allows.
* A walk of K6 over 64-row tiles and those runs, each run's window of B
  zero-filled outside [0, K) and indexed as the kernel indexes it, gives
  ``spmm_dia_ref``'s bits, plain and precise, with NaN where a stored zero
  meets a non-finite B row.
"""

import numpy as np
import pytest
import torch

import sextans_tpu_torch as tx
from sextans_tpu.format.coo import COOMatrix as RefCOO
from sextans_tpu.format.pack_mxu import pack_mxu as ref_pack_mxu
from sextans_tpu.ops.plan import SpmmPlan as RefPlan
from sextans_tpu.utils.config import SpmmConfig as RefConfig
from sextans_tpu_torch.format.convert import from_reference
from sextans_tpu_torch.ops.df32 import acc_step, compensated_epilogue, two_prod
from sextans_tpu_torch.ops.launch import (
    SMEM_LIMIT,
    SharedMemoryError,
    dia_runs,
    f32,
    fma_f32,
    group_ranges,
    slab_visits,
)
from sextans_tpu_torch.ops.spmm_dia import (
    DIA_SPAN_MAX,
    DIA_TILE_ROWS,
    DiaRuns,
    dia_launch,
    dia_plan,
    spmm_dia,
    spmm_dia_ref,
)
from sextans_tpu_torch.ops.spmm_slab import (
    SKINNY_STAGES,
    slab_skinny_launch,
    spmm_slab_padded_ref,
    spmm_slab_skinny_padded,
)

ALPHA, BETA = 0.85, -2.06
MSLAB = 128


def _slab_matrix(kind):
    """A COO matrix whose slab pack has empty slabs (banded), empty M-tiles
    and their pad groups (empty_mtiles), or one slab with many blocks
    (dense_rows)."""
    if kind == "banded":
        return tx.COOMatrix.random(700, 600, 6000, seed=5, banded=True, bandwidth=40)
    rng = np.random.default_rng(6)
    if kind == "empty_mtiles":  # rows 0-99 and 600-649 only
        rows = np.concatenate([rng.integers(0, 100, 2500), rng.integers(600, 650, 800)])
        cols = rng.integers(0, 600, rows.size)
    else:  # rows 130-137 over every column
        rows = np.concatenate([np.repeat(np.arange(130, 138), 600), rng.integers(0, 700, 2000)])
        cols = np.concatenate([np.tile(np.arange(600), 8), rng.integers(0, 600, 2000)])
    lin = np.unique(rows.astype(np.int64) * 600 + cols)
    vals = rng.standard_normal(lin.size).astype(np.float32)
    return tx.COOMatrix((700, 600), lin // 600, lin % 600, vals)


SLAB_CONFIGS = [dict(tile_m=256, window_k=256, block_k=8, group_blocks=4),
                dict(tile_m=512, window_k=512, block_k=16, group_blocks=8),
                dict(tile_m=128, window_k=128, block_k=32, group_blocks=2)]


def _slab_pack(kind, cfg, precise=0):
    return tx.pack_mxu(_slab_matrix(kind), tx.SpmmConfig(**cfg, precise=precise))


def _parent_lists(packed):
    """Each slab's blocks in the order of the M-tile walk: the groups of
    ``group_ranges``, then i, keeping the blocks whose qm is the slab."""
    G = packed.config.group_blocks
    per_tile = packed.config.tile_m // MSLAB
    tile_ptr, tile_groups = group_ranges(packed.group_mtile, packed.n_mtiles)
    lists = [[] for _ in range(packed.n_mtiles * per_tile)]
    for t in range(packed.n_mtiles):
        for g in tile_groups[tile_ptr[t]:tile_ptr[t + 1]]:
            for i in range(G):
                lists[t * per_tile + packed.qm[g, i]].append(g * G + i)
    ptr = np.concatenate([[0], np.cumsum([len(x) for x in lists])]).astype(np.int32)
    return ptr, np.array([b for x in lists for b in x], dtype=np.int32)


@pytest.mark.parametrize("cfg", SLAB_CONFIGS)
@pytest.mark.parametrize("kind", ["banded", "empty_mtiles", "dense_rows"])
def test_slab_visits_list_every_block_once_in_pack_order(kind, cfg):
    packed = _slab_pack(kind, cfg)
    G, per_tile = cfg["group_blocks"], cfg["tile_m"] // MSLAB
    ptr, blocks = slab_visits(packed)
    assert ptr.dtype == blocks.dtype == np.int32
    assert ptr.size == packed.n_mtiles * per_tile + 1 and ptr[0] == 0
    assert np.all(np.diff(ptr) >= 0) and ptr[-1] == blocks.size == packed.n_groups * G
    assert np.array_equal(np.sort(blocks), np.arange(blocks.size))  # each block once
    tiles = packed.group_mtile[:-1].astype(np.int64)
    slab = (tiles[:, None] * per_tile + packed.qm).reshape(-1)
    owner = np.repeat(np.arange(ptr.size - 1), np.diff(ptr))
    assert np.array_equal(slab[blocks], owner)
    for s in range(ptr.size - 1):
        assert np.all(np.diff(blocks[ptr[s]:ptr[s + 1]]) > 0)
    parent_ptr, parent_blocks = _parent_lists(packed)
    assert np.array_equal(ptr, parent_ptr) and np.array_equal(blocks, parent_blocks)
    empty = np.diff(ptr) == 0
    if kind == "banded" and packed.m_padded - packed.m >= MSLAB:
        assert empty.any()  # slabs of padding rows, which no block reaches
    if kind == "empty_mtiles":
        assert empty.any() == (per_tile > 1)  # an empty M-tile's pads go to its slab 0
        zero = ~(packed.vals.reshape(blocks.size, -1) != 0).any(axis=1)
        assert zero.any()  # pad blocks, listed under slab 0 of their M-tile
        assert np.all(packed.qm.reshape(-1)[zero] == 0)
    if kind == "dense_rows":
        assert np.diff(ptr).max() > SKINNY_STAGES


def test_slab_visits_refuses_a_slab_outside_the_tile():
    packed = _slab_pack("banded", SLAB_CONFIGS[0])
    packed.qm[0, 0] = SLAB_CONFIGS[0]["tile_m"] // MSLAB
    with pytest.raises(ValueError, match="qm"):
        slab_visits(packed)


def _walk_slabs(packed, lists, b_p, c_p, precise):
    """K2's loop over ``lists``, each slab's r-th block in one step: the
    FFMA chain over kk from +0, then ``acc += cf`` (a Neumaier step every 8
    terms in precise mode), then the kernel's epilogue."""
    cfg = packed.config
    bk = cfg.block_k
    ptr, blocks = lists
    counts = np.diff(ptr)
    n = b_p.shape[1]
    acc = torch.zeros((counts.size, MSLAB, n))
    comp = torch.zeros_like(acc)
    vblk = torch.from_numpy(packed.vals).view(-1, bk, MSLAB)
    brow = (packed.group_kwin.astype(np.int64)[:, None] * cfg.window_k + packed.bcol).reshape(-1)
    for rank in range(counts.max(initial=0)):
        s = np.flatnonzero(counts > rank)
        blk = blocks[ptr[s] + rank]
        v = vblk[blk]
        rows = b_p[torch.from_numpy(brow[blk][:, None] + np.arange(bk))]
        cf = torch.zeros((s.size, MSLAB, n))
        for kk in range(bk):
            cf = fma_f32(v[:, kk, :, None], rows[:, kk, None, :], cf)
            if precise and kk % 8 == 7:
                acc[s], comp[s] = acc_step(acc[s], comp[s], cf)
                cf = torch.zeros_like(cf)
        if not precise:
            acc[s] = acc[s] + cf
    acc, comp = acc.view(-1, n), comp.view(-1, n)
    if precise:
        return compensated_epilogue(ALPHA, acc, comp, BETA, c_p)
    return fma_f32(torch.full_like(acc, f32(ALPHA)), acc, c_p * f32(BETA))


@pytest.mark.parametrize("precise", [0, 1])
@pytest.mark.parametrize("kind,cfg,n,poison", [
    ("banded", SLAB_CONFIGS[0], 9, None), ("empty_mtiles", SLAB_CONFIGS[1], 16, np.nan),
    ("dense_rows", SLAB_CONFIGS[2], 7, np.inf), ("empty_mtiles", SLAB_CONFIGS[0], 1, -np.inf)])
def test_slab_walk_over_the_scan_keeps_the_parent_order(kind, cfg, n, poison, precise):
    packed = _slab_pack(kind, cfg, precise)
    rng = np.random.default_rng(n)
    b_p = torch.from_numpy(rng.standard_normal((packed.k_padded, n)).astype(np.float32))
    c_p = torch.from_numpy(rng.standard_normal((packed.m_padded, n)).astype(np.float32))
    if poison is not None:  # row 0 of every K-window: the rows pad blocks read
        b_p[::cfg["window_k"]] = float(poison)
    got = _walk_slabs(packed, slab_visits(packed), b_p, c_p, precise)
    parent = _walk_slabs(packed, _parent_lists(packed), b_p, c_p, precise)
    assert torch.equal(torch.isnan(got), torch.isnan(parent))
    assert torch.equal(got.nan_to_num(), parent.nan_to_num())
    assert bool(torch.isfinite(got).all()) == (poison is None)
    plain = spmm_slab_padded_ref(
        *(torch.from_numpy(getattr(packed, a)) for a in
          ("vals", "qm", "bcol", "group_mtile", "group_kwin")),
        b_p, c_p, ALPHA, BETA, precise=precise, **cfg)
    finite = torch.isfinite(plain)
    assert torch.equal(torch.isfinite(got), finite)
    if finite.any():
        tol = 4 * np.spacing(np.float32(plain[finite].abs().max().item()))
        assert (got[finite] - plain[finite]).abs().max().item() <= tol


@pytest.mark.parametrize("n", [5, 16, 32])
def test_slab_walk_matches_the_jax_mxu_route(n):
    coo = _slab_matrix("empty_mtiles")
    ref = ref_pack_mxu(RefCOO(coo.shape, coo.rows, coo.cols, coo.vals),
                       RefConfig(**SLAB_CONFIGS[0]), impl="numpy")
    packed = from_reference(ref)
    rng = np.random.default_rng(n)
    b = rng.standard_normal((coo.shape[1], n)).astype(np.float32)
    c = rng.standard_normal((coo.shape[0], n)).astype(np.float32)
    pl = tx.plan(packed, n, "mxu", device="cpu")
    got = _walk_slabs(packed, slab_visits(packed), pl.pad_b(b), pl.pad_c(c), 0)[:coo.shape[0]]
    jax_out = np.asarray(RefPlan(ref, n, backend="mxu_interpret")(b, ALPHA, BETA, c))
    exact = tx.golden_spmm_exact(tx.CSRMatrix.from_coo(coo), b, ALPHA, BETA, c)
    tol = 4 * np.spacing(np.float32(np.abs(exact).max()))
    assert np.abs(got.numpy() - jax_out).max() <= tol
    assert np.abs(got.numpy() - exact).max() <= tol
    # the wrapper on CPU tensors runs the plain version with the plan's scan
    via = spmm_slab_skinny_padded(*pl.arrays, pl.pad_b(b), pl.pad_c(c), ALPHA, BETA,
                                  ranges=pl.ranges, **SLAB_CONFIGS[0])[:coo.shape[0]]
    assert np.abs(via.numpy() - got.numpy()).max() <= tol
    assert [t.tolist() for t in pl.ranges] == [a.tolist() for a in slab_visits(packed)]


def test_slab_skinny_launch_map_and_refusals():
    # synthetic4704 at bench.py's slab config: 5 M-tiles of 8 slabs, two CTAs a slab
    go = slab_skinny_launch(16, 40, 128)
    assert (go.threads, go.grid) == (128, (80, 1))
    assert go.smem == SKINNY_STAGES * (4 * 128 * (64 + 16) + 8) == 81936
    assert slab_skinny_launch(9, 40, 128).threads == 96  # 4-byte B copies, np = 12
    assert slab_skinny_launch(32, 1, 128).smem == 2 * (4 * 128 * 96 + 8) < SMEM_LIMIT
    assert slab_skinny_launch(1, 3, 8).threads == 32
    with pytest.raises(SharedMemoryError, match="shared memory"):
        slab_skinny_launch(32, 1, 512)
    for n in (0, 33):
        with pytest.raises(ValueError, match="1 <= n <= 32"):
            slab_skinny_launch(n, 1, 8)


OFFSET_CASES = {
    "single": [5],
    "consecutive": list(range(-60, 61)),
    "beyond_k": [-140, -120, -101, -3, 0, 7, 79],  # m = 150, k = 80
    "wide": list(range(-500, 501, 7)),
    "gapped": [-288, -281, -250, -249, -248, -100, 0, 1, 2, 3, 150, 160, 161, 300],
}


@pytest.mark.parametrize("span_max", [0, 5, DIA_SPAN_MAX])
@pytest.mark.parametrize("case", list(OFFSET_CASES))
def test_dia_runs_cover_every_diagonal_once_in_order(case, span_max):
    offs = np.array(OFFSET_CASES[case])
    ptr = dia_runs(offs, span_max)
    assert ptr.dtype == np.int32 and ptr[0] == 0 and ptr[-1] == offs.size
    assert np.all(np.diff(ptr) > 0)  # no empty run: every diagonal once, in order
    for start, stop in zip(ptr[:-1], ptr[1:]):
        assert offs[stop - 1] - offs[start] <= span_max
        if stop < offs.size:  # as long as the limit allows
            assert offs[stop] - offs[start] > span_max
    if span_max == 0:
        assert ptr.tolist() == list(range(offs.size + 1))
    if case == "wide":
        assert ptr.size - 1 > 1  # wider than one window
    assert dia_runs(np.array([], dtype=np.int64), span_max).tolist() == [0]


def test_dia_runs_refuse_unordered_offsets():
    with pytest.raises(ValueError, match="ascend"):
        dia_runs(np.array([3, 1]), 8)
    with pytest.raises(ValueError, match="ascend"):
        dia_runs(np.array([1, 1]), 8)
    with pytest.raises(ValueError, match="span_max"):
        dia_runs(np.array([1]), -1)


def test_dia_plan_and_launch_map():
    runs = dia_plan(np.array(OFFSET_CASES["consecutive"]), "cpu")  # scircuit_like's
    assert runs.ptr.tolist() == [0, 65, 121] and (runs.span, runs.length) == (64, 65)
    # scircuit_like at N = 512: 2,672 row tiles x 8 column tiles, four CTAs an SM
    go = dia_launch(512, 170998, runs, 4)
    assert (go.threads, go.grid, go.cols) == (128, (21376, 1), 4)
    assert go.smem == 4 * ((64 + 64 + 8) * 64 + 65 * 65) == 51716
    assert 4 * (go.smem + 1024) <= 228 * 1024
    assert dia_launch(37, 900, runs, 1).grid == (15 * 3, 1)
    gapped = dia_plan(np.array(OFFSET_CASES["gapped"]), "cpu")
    assert gapped.ptr.tolist() == [0, 5, 6, 10, 13, 14]
    assert (gapped.span, gapped.length) == (40, 5)
    wide_offs = np.array(OFFSET_CASES["wide"])  # 143 offsets 7 apart: runs of 10
    wide = dia_plan(wide_offs, "cpu")
    assert wide.ptr.tolist() == dia_runs(wide_offs, DIA_SPAN_MAX).tolist()
    assert wide.ptr.numel() - 1 == 15 and (wide.span, wide.length) == (63, 10)
    assert wide.offsets.dtype == torch.int32 and wide.offsets.tolist() == wide_offs.tolist()
    # dia_plan never asks for more; a plan built by hand may
    by_hand = DiaRuns(torch.tensor([-1200, 1200], dtype=torch.int32),
                      torch.tensor([0, 2], dtype=torch.int32), 2400, 2)
    with pytest.raises(SharedMemoryError, match="shared memory"):
        dia_launch(512, 1000, by_hand, 4)


@pytest.mark.parametrize("offsets,ptr,span,length,fits", [
    ([-7, 3, 9], [0, 1, 2, 3], 0, 1, True),  # a cut finer than dia_plan's
    ([-7, 3, 9], [0, 3], 16, 3, True),  # dia_plan's cut
    ([-1200, 1200], [0, 2], 1, 2, False),  # a run wider than span
    ([-7, 3], [0, 1], 0, 1, False),  # the runs stop short of D
    ([-7, 3], [0, 1, 2, 3], 0, 1, False),  # past D
    ([-7, 3], [0, 0, 2], 10, 2, False),  # an empty run
    ([0, 1], [0, 2], 1, 1, False),  # a run longer than length
    ([0, 2, 1], [0, 3], 2, 3, False),  # offsets not ascending
    ([], [0], 0, 0, True),  # no diagonal
])
def test_dia_runs_built_by_hand_are_held_to_their_offsets(offsets, ptr, span, length, fits):
    def build():
        return DiaRuns(torch.tensor(offsets, dtype=torch.int32),
                       torch.tensor(ptr, dtype=torch.int32), span, length)

    if fits:
        assert build().ptr.tolist() == ptr
    else:  # a plan that would stage past the shared memory it sizes
        with pytest.raises(ValueError, match="DiaRuns"):
            build()


def _walk_dia(dvals, offsets, b, c, runs_ptr, precise):
    """K6 over 64-row tiles and the runs: each run's window of B rows
    row0 + off_first .. row0 + 63 + off_last, zero outside [0, k); diagonal
    d reads window rows off_d - off_first + (0 .. 63); one FFMA (precise:
    two_prod and a Neumaier step) per diagonal in run order; the epilogue."""
    n_diags, m = dvals.shape
    k, n = b.shape
    offs = offsets.tolist()
    out_acc = torch.zeros((m, n))
    out_comp = torch.zeros((m, n))
    for row0 in range(0, m, DIA_TILE_ROWS):
        rows = min(DIA_TILE_ROWS, m - row0)
        acc = torch.zeros((rows, n))
        comp = torch.zeros((rows, n))
        for start, stop in zip(runs_ptr[:-1], runs_ptr[1:]):
            off0, last = offs[start], offs[stop - 1] - offs[start]
            grow = row0 + off0 + np.arange(DIA_TILE_ROWS + last)
            inside = (grow >= 0) & (grow < k)
            win = torch.zeros((grow.size, n))
            win[torch.from_numpy(inside)] = b[torch.from_numpy(grow[inside])]
            for d in range(start, stop):
                rel = offs[d] - off0
                x = win[rel:rel + rows]
                v = dvals[d, row0:row0 + rows, None]
                if precise:
                    acc, comp = acc_step(acc, comp, *two_prod(v, x))
                else:
                    acc = fma_f32(v, x, acc)
        out_acc[row0:row0 + rows], out_comp[row0:row0 + rows] = acc, comp
    if precise:
        return compensated_epilogue(ALPHA, out_acc, out_comp, BETA, c)
    return fma_f32(torch.full_like(out_acc, f32(ALPHA)), out_acc, c * f32(BETA))


@pytest.mark.parametrize("precise", [0, 1])
@pytest.mark.parametrize("case,span_max", [
    ("single", DIA_SPAN_MAX), ("consecutive", DIA_SPAN_MAX), ("consecutive", 7),
    ("beyond_k", DIA_SPAN_MAX), ("beyond_k", 0), ("gapped", 40), ("gapped", DIA_SPAN_MAX)])
def test_dia_walk_over_runs_gives_the_plain_versions_bits(case, span_max, precise):
    m, k, n = (150, 80, 5) if case == "beyond_k" else (200, 230, 6)
    rng = np.random.default_rng(len(OFFSET_CASES[case]))
    offsets = torch.tensor(OFFSET_CASES[case], dtype=torch.int32)
    dvals = torch.from_numpy(rng.standard_normal((offsets.numel(), m)).astype(np.float32))
    dvals[:, ::3] = 0.0  # stored zeros, multiplied as any entry
    b = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32))
    b[k // 2] = float("nan")  # reaches every row whose diagonals read it
    c = torch.from_numpy(rng.standard_normal((m, n)).astype(np.float32))
    ptr = dia_runs(offsets.numpy(), span_max)
    got = _walk_dia(dvals, offsets, b, c, ptr, precise)
    want = spmm_dia_ref(dvals, offsets, b, c, ALPHA, BETA, precise=precise)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(got.nan_to_num(), want.nan_to_num())
    rows_meeting_nan = {k // 2 - o for o in OFFSET_CASES[case] if 0 <= k // 2 - o < m}
    assert set(torch.isnan(want).any(dim=1).nonzero().flatten().tolist()) == rows_meeting_nan
    # the wrapper on CPU tensors runs the plain version; it does not read runs
    via = spmm_dia(dvals, offsets, b, c, ALPHA, BETA, precise=precise,
                   runs=dia_plan(offsets.numpy(), "cpu"))
    assert torch.equal(via.nan_to_num(), want.nan_to_num())
