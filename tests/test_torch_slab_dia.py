"""The host scans and the arithmetic order of the slab kernels (K1, K2)
and the DIA kernels (K6, K7), on the CPU.

* ``slab_visits`` lists every block of a slab pack once: each block that
  holds a nonzero, and of the all-zero blocks the first per (slab,
  K-window, bcol), under its (M-tile, ``qm``) slab, in the order in which
  the parent kernels took them (the M-tile's groups in group order, then
  the blocks of a group; pad groups and empty slabs and M-tiles included),
  the other all-zero blocks parked after the last slab's list; beside each
  block, the B row where its terms start. Both slab kernels walk it at
  every N (``SpmmPlan``).
* A walk of the FFMA loop over those lists (per block the FFMA chain over
  kk from +0 by ``fma_f32``, then ``acc += cf``, or a Neumaier step after
  every 8 terms in precise mode; the kernel's epilogue) gives the same bits
  as the same walk over the M-tile group ranges with the ``qm`` test, and
  as K1's walk in chunks of 32 terms, with NaN and Inf where pad blocks
  read; it is within 4 ulp of the plain version ``spmm_slab_padded_ref`` and
  of the JAX package's ``mxu_interpret`` route.
* K1's 3xTF32 split (``tf32_rna``, ``slab_image``) against a NumPy
  emulation of ``cvt.rna.tf32.f32``, its error bound over a 128-term block,
  and a walk of K1's plain-mode steps against the plain version and f64.
* ``dia_runs`` covers every diagonal once, in ascending order, in runs
  whose span is at most the limit, each as long as the limit allows.
* A walk of K6 (64-row tiles) and K7 (16- and 64-row tiles) over those runs,
  each run's window of B zero-filled outside [0, K) and indexed as the
  kernel indexes it, gives ``spmm_dia_ref``'s bits, plain and precise, with
  NaN where a stored zero meets a non-finite B row.
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
    slab_visits,
)
from sextans_tpu_torch.ops.serve import bucketize_pack
from sextans_tpu_torch.utils.config import round_up
from sextans_tpu_torch.ops.spmm_dia import (
    DIA_SPAN_MAX,
    DIA_TILE_ROWS,
    DiaRuns,
    dia_launch,
    dia_plan,
    dia_skinny_launch,
    spmm_dia,
    spmm_dia_ref,
    spmm_dia_skinny,
)
from sextans_tpu_torch.ops.spmm_slab import (
    SKINNY_STAGES,
    SLAB_CHUNK,
    slab_image,
    slab_launch,
    slab_skinny_launch,
    spmm_slab_padded,
    spmm_slab_padded_ref,
    spmm_slab_skinny_padded,
    tf32_rna,
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
    """Each slab's blocks in the order of the parent's M-tile walk: each
    M-tile's groups in group order (the packers append the groups of empty
    M-tiles after all real ones), then i, keeping the blocks whose qm is
    the slab."""
    G = packed.config.group_blocks
    per_tile = packed.config.tile_m // MSLAB
    mtile = packed.group_mtile[:-1]
    lists = [[] for _ in range(packed.n_mtiles * per_tile)]
    for t in range(packed.n_mtiles):
        for g in np.flatnonzero(mtile == t):
            for i in range(G):
                lists[t * per_tile + packed.qm[g, i]].append(g * G + i)
    ptr = np.concatenate([[0], np.cumsum([len(x) for x in lists])]).astype(np.int32)
    return ptr, np.array([b for x in lists for b in x], dtype=np.int32)


def _kept_lists(packed):
    """The parent's lists with the all-zero blocks after the first of each
    (slab, K-window, bcol) dropped, by a plain loop."""
    G = packed.config.group_blocks
    ptr, blocks = _parent_lists(packed)
    zero = ~(packed.vals.reshape(packed.n_groups * G, -1) != 0).any(axis=1)
    lists = []
    for s in range(ptr.size - 1):
        seen, kept = set(), []
        for b in blocks[ptr[s]:ptr[s + 1]]:
            key = (packed.group_kwin[b // G], packed.bcol[b // G, b % G])
            if not zero[b] or key not in seen:
                kept.append(b)
            if zero[b]:
                seen.add(key)
        lists.append(kept)
    ptr = np.concatenate([[0], np.cumsum([len(x) for x in lists])]).astype(np.int32)
    return ptr, np.array([b for x in lists for b in x], dtype=np.int32)


@pytest.mark.parametrize("cfg", SLAB_CONFIGS)
@pytest.mark.parametrize("kind", ["banded", "empty_mtiles", "dense_rows"])
def test_slab_visits_list_every_block_once_in_pack_order(kind, cfg):
    packed = _slab_pack(kind, cfg)
    G, per_tile = cfg["group_blocks"], cfg["tile_m"] // MSLAB
    ptr, blocks, rows = slab_visits(packed)
    assert ptr.dtype == blocks.dtype == rows.dtype == np.int32
    brow = (packed.group_kwin.astype(np.int64)[:, None] * cfg["window_k"] + packed.bcol)
    assert np.array_equal(rows, brow.reshape(-1)[blocks])
    assert ptr.size == packed.n_mtiles * per_tile + 1 and ptr[0] == 0
    assert np.all(np.diff(ptr) >= 0) and ptr[-1] <= blocks.size == packed.n_groups * G
    assert np.array_equal(np.sort(blocks), np.arange(blocks.size))  # each block once
    zero = ~(packed.vals.reshape(packed.n_groups * G, -1) != 0).any(axis=1)
    assert not zero[blocks[ptr[-1]:]].size or zero[blocks[ptr[-1]:]].all()  # parked: pads
    assert np.array_equal(blocks[ptr[-1]:], np.sort(blocks[ptr[-1]:]))
    tiles = packed.group_mtile[:-1].astype(np.int64)
    slab = (tiles[:, None] * per_tile + packed.qm).reshape(-1)
    owner = np.repeat(np.arange(ptr.size - 1), np.diff(ptr))
    assert np.array_equal(slab[blocks[:ptr[-1]]], owner)
    for s in range(ptr.size - 1):
        assert np.all(np.diff(blocks[ptr[s]:ptr[s + 1]]) > 0)
    kept_ptr, kept_blocks = _kept_lists(packed)
    assert np.array_equal(ptr, kept_ptr) and np.array_equal(blocks[:ptr[-1]], kept_blocks)
    empty = np.diff(ptr) == 0
    if kind == "banded" and packed.m_padded - packed.m >= MSLAB:
        assert empty.any()  # slabs of padding rows, which no block reaches
    if kind == "empty_mtiles":
        assert empty.any() == (per_tile > 1)  # an empty M-tile's pads go to its slab 0
        assert zero[blocks[:ptr[-1]]].any()  # pad blocks, listed under slab 0 of their M-tile
        assert np.all(packed.qm.reshape(-1)[zero] == 0)
    if kind == "dense_rows":
        assert np.diff(ptr).max() > SKINNY_STAGES


def test_slab_visits_refuses_a_slab_outside_the_tile():
    packed = _slab_pack("banded", SLAB_CONFIGS[0])
    packed.qm[0, 0] = SLAB_CONFIGS[0]["tile_m"] // MSLAB
    with pytest.raises(ValueError, match="qm"):
        slab_visits(packed)


def _walk_slabs(packed, lists, b_p, c_p, precise, chunk=None):
    """The FFMA loop over ``lists`` (K2's, and K1's in precise mode), each
    slab's r-th block in one step: the FFMA chain over kk from +0, then
    ``acc += cf`` (a Neumaier step every 8 terms in precise mode), then the
    kernel's epilogue. With ``chunk`` the chain goes stage by stage, as K1
    streams a block: ``chunk`` terms a stage, the block's sums carried."""
    cfg = packed.config
    bk = cfg.block_k
    ptr, blocks = lists[:2]
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
        for k0 in range(0, bk, chunk or bk):
            for kk in range(k0, k0 + (chunk or bk)):
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


# a block of 64 terms: K1 streams it in two chunks
WIDE_BLOCK = dict(tile_m=256, window_k=512, block_k=64, group_blocks=2)


@pytest.mark.parametrize("precise", [0, 1])
@pytest.mark.parametrize("kind,cfg,n,poison", [
    ("banded", SLAB_CONFIGS[0], 9, None), ("empty_mtiles", SLAB_CONFIGS[1], 16, np.nan),
    ("dense_rows", SLAB_CONFIGS[2], 7, np.inf), ("empty_mtiles", SLAB_CONFIGS[0], 1, -np.inf),
    ("empty_mtiles", WIDE_BLOCK, 40, np.nan), ("dense_rows", WIDE_BLOCK, 100, None)])
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
    # K1 streams a block in chunks of 32 terms; its sums carry across them
    chunked = _walk_slabs(packed, slab_visits(packed), b_p, c_p, precise,
                          chunk=min(SLAB_CHUNK, cfg["block_k"]))
    assert torch.equal(chunked.nan_to_num(), got.nan_to_num())
    assert torch.equal(torch.isnan(chunked), torch.isnan(got))
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


@pytest.mark.parametrize("precise", [0, 1])
@pytest.mark.parametrize("poison", [None, np.nan])
def test_slab_walk_over_a_bucketized_pack(poison, precise):
    """A served slab pack (ops/serve.py) appends zero-valued pad groups to
    slab 0 of its last M-tile: the scan keeps one of them, so no slab's list
    grows by more than one block, and the walk still gives the parent
    lists' bits and, on the real rows, the unbucketed pack's."""
    packed = _slab_pack("banded", SLAB_CONFIGS[0], precise)
    served = bucketize_pack(packed)
    assert served.n_groups > packed.n_groups
    assert np.diff(slab_visits(served)[0]).max() <= np.diff(slab_visits(packed)[0]).max() + 1
    rng = np.random.default_rng(3)
    b_p = torch.zeros((served.k_padded, 24))
    b_p[:packed.k_padded] = torch.from_numpy(
        rng.standard_normal((packed.k_padded, 24)).astype(np.float32))
    if poison is not None:
        b_p[0] = float(poison)  # the row the pad blocks read
    c_p = torch.zeros((served.m_padded, 24))
    c_p[:packed.m_padded] = torch.from_numpy(
        rng.standard_normal((packed.m_padded, 24)).astype(np.float32))
    got = _walk_slabs(served, slab_visits(served), b_p, c_p, precise)
    parent = _walk_slabs(served, _parent_lists(served), b_p, c_p, precise)
    assert torch.equal(got.nan_to_num(), parent.nan_to_num())
    assert torch.equal(torch.isnan(got), torch.isnan(parent))
    base = _walk_slabs(packed, slab_visits(packed), b_p[:packed.k_padded],
                       c_p[:packed.m_padded], precise)
    m = packed.m
    assert torch.equal(got[:m].nan_to_num(), base[:m].nan_to_num())
    assert torch.equal(torch.isnan(got[:m]), torch.isnan(base[:m]))


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


def _tf32_numpy(x):
    """``cvt.rna.tf32.f32`` in NumPy: x to 11 significant bits, to nearest
    with ties away from zero, by its f64 mantissa (frexp), not its bits."""
    x = np.asarray(x, dtype=np.float64)
    mant, exp = np.frexp(x)
    return (np.sign(mant) * np.floor(np.abs(mant) * 2.0**11 + 0.5) * 2.0**(exp - 11)).astype(
        np.float32)


def test_tf32_rna_matches_a_numpy_emulation():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.standard_normal(4000) * 10.0**rng.integers(-30, 30, 4000),
                        [0.0, -0.0, 1.0, -3.5, 2.0**-126, 3.4e38, -3.4e38]]).astype(np.float32)
    # halfway between two TF32 values: the 13 dropped bits are 1 followed by zeros
    ties = (np.arange(1, 200, dtype=np.uint32) << 13 | 0x1000 | 0x3F800000).view(np.float32)
    x = np.concatenate([x, ties, -ties])
    got = tf32_rna(torch.from_numpy(x)).numpy()
    assert np.array_equal(got, _tf32_numpy(x))
    assert np.all(got.view(np.uint32) & 0x1FFF == 0)
    assert np.all(np.abs(got[-2 * ties.size:]) > np.abs(x[-2 * ties.size:]))  # ties away
    # past the largest TF32 value below the f32 maximum, the instruction
    # rounds to infinity, as the bit trick does
    big = np.array([np.finfo(np.float32).max], dtype=np.float32)
    assert np.isinf(tf32_rna(torch.from_numpy(big)).numpy()).all()


def test_3xtf32_split_and_its_error_over_a_block():
    rng = np.random.default_rng(1)
    # hi + lo gives x back where x has at most 22 significant bits, the 11 of
    # hi and the 11 of lo
    exact = (rng.integers(1 << 21, 1 << 22, 2000) * 2.0**rng.integers(-40, 20, 2000)).astype(
        np.float32)
    hi = _tf32_numpy(exact)
    lo = _tf32_numpy(exact.astype(np.float64) - hi)
    assert np.array_equal(hi.astype(np.float64) + lo, exact)
    # any x: |x - hi - lo| <= 2^-22 |x| (lo rounds the 13 bits below hi to 11)
    x = rng.standard_normal(100_000).astype(np.float32)
    hi = _tf32_numpy(x)
    lo = _tf32_numpy(x.astype(np.float64) - hi)
    assert np.all(np.abs(x - (hi.astype(np.float64) + lo)) <= 2.0**-22 * np.abs(x))
    # a block of 128 terms: hi.hi + hi.lo + lo.hi (products and sum in f64,
    # exact here) leaves out lo.lo and both operands' split errors, at most
    # (2^-22 + 2^-22 + 2^-22 + small) |a b| a term: bound 3.01 * 2^-22 * sum |a b|
    for _ in range(50):
        a = rng.standard_normal(128).astype(np.float32) * (rng.random(128) < 0.3)
        b = rng.standard_normal(128).astype(np.float32)
        ah, bh = _tf32_numpy(a), _tf32_numpy(b)
        al = _tf32_numpy(a.astype(np.float64) - ah)
        bl = _tf32_numpy(b.astype(np.float64) - bh)
        three = np.sum(ah.astype(np.float64) * bh + ah.astype(np.float64) * bl
                       + al.astype(np.float64) * bh)
        exact_dot = np.sum(a.astype(np.float64) * b)
        bound = 3.01 * 2.0**-22 * np.sum(np.abs(a.astype(np.float64) * b))
        assert abs(three - exact_dot) <= bound


def test_slab_image_lays_out_k_major_tiles():
    rng = np.random.default_rng(2)
    for bk in (8, 32, 128):
        ch = min(SLAB_CHUNK, bk)
        vals = torch.from_numpy(rng.standard_normal((3, 2 * bk, MSLAB)).astype(np.float32))
        img = slab_image(vals, bk)
        assert img.shape == (6, bk // ch, 2, 2, ch // 8, 512) and img.is_contiguous()
        v = vals.reshape(6, bk, MSLAB).numpy()
        k = np.arange(bk)[:, None]
        mm = np.arange(MSLAB)[None, :]
        c, kin = k // ch, k % ch
        ks, kc, e = kin // 8, kin % 8 // 4, kin % 4
        half, ng, r = mm // 64, mm % 64 // 8, mm % 8
        at = (c, half, ks, ng * 64 + kc * 32 + r * 4 + e)
        for blk in range(6):
            hi = _tf32_numpy(v[blk])
            lo = _tf32_numpy(v[blk].astype(np.float64) - hi)
            tiles = img[blk].numpy()
            assert np.array_equal(tiles[at[0], at[1], 0, at[2], at[3]], hi)
            assert np.array_equal(tiles[at[0], at[1], 1, at[2], at[3]], lo)
    with pytest.raises(ValueError, match="block_k"):
        slab_image(torch.zeros((1, 4, MSLAB)), 4)


def test_slab_launch_map_and_its_ring():
    # synthetic4704 at bench.py's slab config: 40 slabs; at N = 512 the wide
    # tiles would give 160 CTAs, so half a slab by 64 columns: 640 CTAs of
    # one warpgroup, four stages of 32 terms (hi and lo tiles and B rows)
    go = slab_launch(512, 40, 128)
    assert (go.lanes, go.cols, go.threads, go.grid) == (64, 64, 128, (640, 1))
    assert go.smem == 4 * (4 * 32 * (128 + 64 + 8) + 8) == 102432
    # cant_like: 496 slabs, 1,984 CTAs of a whole slab by 128 columns
    go = slab_launch(512, 496, 128)
    assert (go.lanes, go.cols, go.threads, go.grid) == (128, 128, 256, (1984, 1))
    assert go.smem == 4 * (4 * 32 * (256 + 128 + 8) + 8) == 200736 <= SMEM_LIMIT
    # ragged N: the last column tile is partly outside
    assert slab_launch(100, 40, 128).grid == (40 * 2 * 2, 1)
    assert slab_launch(37, 40, 128).grid == (40 * 2, 1)
    # precise mode: FFMA, half a slab by 64 columns, the values and B rows
    go = slab_launch(512, 496, 128, precise=1)
    assert (go.lanes, go.cols, go.threads, go.grid) == (64, 64, 128, (7936, 1))
    assert go.smem == 4 * (4 * 32 * (64 + 64 + 8) + 8) == 69664
    # a stage holds at most 32 terms: the ring fits at any block_k
    for bk in (8, 16, 32, 64, 128, 512):
        for n_slabs in (1, 40, 496):
            for precise in (0, 1):
                assert slab_launch(512, n_slabs, bk, precise).smem <= SMEM_LIMIT
    assert slab_launch(512, 40, 8).smem == 4 * (4 * 8 * 200 + 8)
    with pytest.raises(ValueError, match="block_k % 8"):
        slab_launch(512, 40, 4)
    with pytest.raises(ValueError, match="n >= 1"):
        slab_launch(0, 40, 128)


BENCH_SLAB = dict(tile_m=1024, window_k=4096, block_k=128, group_blocks=8)


@pytest.mark.parametrize("cfg", [{}, BENCH_SLAB])
@pytest.mark.parametrize("n", [512, 100, 16])
def test_slab_visits_are_both_slab_kernels_ranges(cfg, n):
    packed = tx.pack_mxu(_slab_matrix("banded"), tx.SpmmConfig(**cfg))
    pl = tx.plan(packed, n, "mxu", device="cpu")
    assert [t.tolist() for t in pl.ranges] == [a.tolist() for a in slab_visits(packed)]
    assert pl.image is None  # made on the card, where K1 reads it
    # the wrappers on CPU tensors run the plain version, with the plan's scan
    rng = np.random.default_rng(n)
    b_p = pl.pad_b(rng.standard_normal((packed.k, n)).astype(np.float32))
    c_p = pl.pad_c(rng.standard_normal((packed.m, n)).astype(np.float32))
    cfg = packed.config
    kw = dict(tile_m=cfg.tile_m, window_k=cfg.window_k, block_k=cfg.block_k,
              group_blocks=cfg.group_blocks)
    kernel = spmm_slab_skinny_padded if n <= 32 else spmm_slab_padded
    via = kernel(*pl.arrays, b_p, c_p, ALPHA, BETA, ranges=pl.ranges, **kw)
    assert torch.equal(via, spmm_slab_padded_ref(*pl.arrays, b_p, c_p, ALPHA, BETA, **kw))


def _walk_tc(packed, b_p, c_p):
    """K1's plain mode over ``slab_visits``, each slab's r-th block in one
    step: per 8 terms the 3xTF32 sum (products and their sum in f64, rounded
    to f32 once; the card's tensor cores do not round that sum to nearest),
    added to the block's sum cf, cf to acc after the block; the epilogue."""
    cfg = packed.config
    bk = cfg.block_k
    ptr, blocks, rows = slab_visits(packed)
    counts = np.diff(ptr)
    n = b_p.shape[1]
    acc = torch.zeros((counts.size, MSLAB, n))
    vblk = torch.from_numpy(packed.vals).view(-1, bk, MSLAB)
    bh = tf32_rna(b_p)
    bl = tf32_rna(b_p - bh)
    for rank in range(counts.max(initial=0)):
        s = np.flatnonzero(counts > rank)
        blk = blocks[ptr[s] + rank]
        v = vblk[blk]
        vh = tf32_rna(v)
        vl = tf32_rna(v - vh)
        at = torch.from_numpy(rows[ptr[s] + rank][:, None] + np.arange(bk))
        cf = torch.zeros((s.size, MSLAB, n))
        for k0 in range(0, bk, 8):
            ks = slice(k0, k0 + 8)
            f = (torch.einsum("skm,skn->smn", vl[:, ks].double(), bh[at[:, ks]].double())
                 + torch.einsum("skm,skn->smn", vh[:, ks].double(), bl[at[:, ks]].double())
                 + torch.einsum("skm,skn->smn", vh[:, ks].double(), bh[at[:, ks]].double()))
            cf = cf + f.float()
        acc[s] = acc[s] + cf
    acc = acc.view(-1, n)
    return fma_f32(torch.full_like(acc, f32(ALPHA)), acc, c_p * f32(BETA))


@pytest.mark.parametrize("kind,cfg,n,poison", [
    ("banded", WIDE_BLOCK, 40, None), ("dense_rows", SLAB_CONFIGS[1], 100, None),
    ("empty_mtiles", WIDE_BLOCK, 37, np.nan), ("empty_mtiles", SLAB_CONFIGS[0], 64, np.inf)])
def test_slab_tc_walk_against_the_plain_version_and_f64(kind, cfg, n, poison):
    packed = _slab_pack(kind, cfg)
    rng = np.random.default_rng(n)
    b_p = torch.from_numpy(rng.standard_normal((packed.k_padded, n)).astype(np.float32))
    c_p = torch.from_numpy(rng.standard_normal((packed.m_padded, n)).astype(np.float32))
    if poison is not None:  # row 0 of every K-window: the rows pad blocks read
        b_p[::cfg["window_k"]] = float(poison)
    got = _walk_tc(packed, b_p, c_p)
    arrays = [torch.from_numpy(getattr(packed, a))
              for a in ("vals", "qm", "bcol", "group_mtile", "group_kwin")]
    plain = spmm_slab_padded_ref(*arrays, b_p, c_p, ALPHA, BETA, **cfg)
    # a non-finite B element makes its lo part NaN, so every product with it
    # is NaN (FFMA gives +-Inf for a nonzero value): the same cells are
    # non-finite either way
    finite = torch.isfinite(plain)
    assert torch.equal(torch.isfinite(got), finite)
    assert bool(finite.all()) == (poison is None)
    coo = _slab_matrix(kind)
    m, k = coo.shape
    a64 = np.zeros((m, k))
    np.add.at(a64, (coo.rows, coo.cols), coo.vals.astype(np.float64))
    b64 = b_p[:k].double().numpy()
    b64[~np.isfinite(b64)] = 0.0  # the finite cells meet none of these rows
    want = torch.from_numpy(ALPHA * a64 @ b64 + BETA * c_p[:m].double().numpy())
    got, plain, finite = got[:m], plain[:m], finite[:m]
    unit = np.spacing(np.float32(want[finite].abs().max().item()))
    # each step's products are exact and their sum rounds once: within the
    # plain-mode bar of f64 (4 ulp of max|C|) and of the plain version
    assert (got[finite].double() - want[finite]).abs().max().item() <= 4 * unit
    assert (got[finite] - plain[finite]).abs().max().item() <= 4 * unit


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


def _walk_dia(dvals, offsets, b, c, runs_ptr, precise, tile=DIA_TILE_ROWS):
    """K6 (64-row tiles) or K7 (16 or 64) over tiles of ``tile`` rows and
    the runs: each run's window of B rows row0 + off_first .. row0 + tile -
    1 + off_last, zero outside [0, k); diagonal d reads window rows off_d -
    off_first + (0 .. tile - 1); one FFMA (precise: two_prod and a Neumaier
    step) per diagonal in run order; the epilogue."""
    n_diags, m = dvals.shape
    k, n = b.shape
    offs = offsets.tolist()
    out_acc = torch.zeros((m, n))
    out_comp = torch.zeros((m, n))
    for row0 in range(0, m, tile):
        rows = min(tile, m - row0)
        acc = torch.zeros((rows, n))
        comp = torch.zeros((rows, n))
        for start, stop in zip(runs_ptr[:-1], runs_ptr[1:]):
            off0, last = offs[start], offs[stop - 1] - offs[start]
            grow = row0 + off0 + np.arange(tile + last)
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


@pytest.mark.parametrize("tile", [DIA_TILE_ROWS, 16])
@pytest.mark.parametrize("precise", [0, 1])
@pytest.mark.parametrize("case,span_max", [
    ("single", DIA_SPAN_MAX), ("consecutive", DIA_SPAN_MAX), ("consecutive", 7),
    ("beyond_k", DIA_SPAN_MAX), ("beyond_k", 0), ("gapped", 40), ("gapped", DIA_SPAN_MAX)])
def test_dia_walk_over_runs_gives_the_plain_versions_bits(case, span_max, precise, tile):
    m, k, n = (150, 80, 5) if case == "beyond_k" else (200, 230, 6)
    rng = np.random.default_rng(len(OFFSET_CASES[case]))
    offsets = torch.tensor(OFFSET_CASES[case], dtype=torch.int32)
    dvals = torch.from_numpy(rng.standard_normal((offsets.numel(), m)).astype(np.float32))
    dvals[:, ::3] = 0.0  # stored zeros, multiplied as any entry
    b = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32))
    b[k // 2] = float("nan")  # reaches every row whose diagonals read it
    c = torch.from_numpy(rng.standard_normal((m, n)).astype(np.float32))
    ptr = dia_runs(offsets.numpy(), span_max)
    got = _walk_dia(dvals, offsets, b, c, ptr, precise, tile)
    want = spmm_dia_ref(dvals, offsets, b, c, ALPHA, BETA, precise=precise)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(got.nan_to_num(), want.nan_to_num())
    rows_meeting_nan = {k // 2 - o for o in OFFSET_CASES[case] if 0 <= k // 2 - o < m}
    assert set(torch.isnan(want).any(dim=1).nonzero().flatten().tolist()) == rows_meeting_nan
    # the wrappers on CPU tensors run the plain version; they do not read runs
    for kernel in (spmm_dia, spmm_dia_skinny):
        via = kernel(dvals, offsets, b, c, ALPHA, BETA, precise=precise,
                     runs=dia_plan(offsets.numpy(), "cpu"))
        assert torch.equal(via.nan_to_num(), want.nan_to_num())


def test_dia_skinny_launch_map_and_run_plans():
    # laplace3d_64's offsets under dia_plan: -4096 | -64, -1, 0 | 1, 64 | 4096
    lap = dia_plan(np.array([-4096, -64, -1, 0, 1, 64, 4096]), "cpu")
    assert lap.ptr.tolist() == [0, 1, 4, 6, 7] and (lap.span, lap.length) == (64, 3)
    # M = 262,144: 4,096 tiles of 64 rows fill the card four times over
    go = dia_skinny_launch(16, 262144, lap)
    assert (go.lanes, go.cols, go.threads, go.grid) == (64, 4, 256, (4096, 1))
    assert go.smem == 2 * 4 * round_up((64 + 64) * 16 + 3 * 65, 4) == 17952
    # synthetic4704's 256 diagonals at N = 16: nine runs; 4,704 rows give 74
    # tiles of 64, too few, so 294 tiles of 16 rows
    split = tx.split_structure(tx.COOMatrix.random(4704, 4704, 104756, seed=42, banded=True,
                                                   bandwidth=300), n=16)
    syn = dia_plan(split.diag_offsets, "cpu")
    assert split.diag_offsets.size == 256 and syn.ptr.numel() - 1 == 9 and syn.span <= 64
    go = dia_skinny_launch(16, 4704, syn)
    assert (go.lanes, go.cols, go.threads, go.grid) == (16, 1, 256, (294, 1))
    assert go.smem == 4 * 4 * round_up((16 + syn.span) * 16 + syn.length * 17, 4)
    assert dia_skinny_launch(9, 4704, syn).threads == 160  # 144 cells, a thread each
    assert dia_skinny_launch(1, 4704, syn).threads == 32
    assert dia_skinny_launch(32, 4704, syn).threads == 512
    go = dia_skinny_launch(32, 262144, lap)
    assert (go.cols, go.threads) == (4, 512)  # 2,048 cells, 4 a thread
    assert dia_skinny_launch(9, 262144, lap).threads == 160  # 576 cells
    for n in (0, 33):
        with pytest.raises(ValueError, match="1 <= n <= 32"):
            dia_skinny_launch(n, 4704, syn)
    by_hand = DiaRuns(torch.tensor([-9000, 9000], dtype=torch.int32),
                      torch.tensor([0, 2], dtype=torch.int32), 18000, 2)
    with pytest.raises(SharedMemoryError, match="shared memory"):
        dia_skinny_launch(16, 4704, by_hand)
