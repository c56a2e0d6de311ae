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
* K6's entry map (``dia_entry_map``) lists every slot of ``dvals`` that holds
  a value once (NaN included) and no other, in ascending offset order
  within a row, past M and past B's ends too; ``spmm_dia`` walks a map only
  beside the ``dvals`` and offsets it was made from; and a walk of K6's
  entry walk over it (its slots, and the dense walk in a window that holds
  a value that is not finite) gives ``spmm_dia_ref``'s bits, plain and
  precise, on a stencil's band and on a synthetic and a circuit split.
"""

import torch_cpu  # noqa: F401  one torch thread per xdist worker

import json
from pathlib import Path

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
    f32,
    fma_f32,
)
from sextans_tpu_torch.ops.serve import bucketize_pack
from sextans_tpu_torch.utils.config import round_up
from sextans_tpu_torch.ops.spmm_dia import (
    DIA_ENTRY_SPAN_MAX,
    DIA_SPAN_MAX,
    DIA_TILE_ROWS,
    DiaEntries,
    DiaRuns,
    check_entry_map,
    dia_entries,
    dia_entry_launch,
    dia_entry_map,
    dia_launch,
    dia_plan,
    dia_runs,
    dia_skinny_launch,
    entry_walk_slots,
    spmm_dia,
    spmm_dia_ref,
    spmm_dia_skinny,
)
from sextans_tpu_torch.utils.matrices import circuit_like, stencil_3d
from sextans_tpu_torch.ops.spmm_slab import (
    SKINNY_STAGES,
    SLAB_CHUNK,
    slab_image,
    slab_launch,
    slab_skinny_launch,
    slab_visits,
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
                                  ranges=pl.ranges, m=pl.m, k=pl.k,
                                  **SLAB_CONFIGS[0])[:coo.shape[0]]
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
    # one warpgroup, four stages of 32 terms (hi and lo tiles and B rows),
    # each beside its mbarrier and the counter that frees it
    go = slab_launch(512, 40, 128)
    assert (go.lanes, go.cols, go.threads, go.grid) == (64, 64, 128, (640, 1))
    assert go.smem == 4 * (4 * 32 * (128 + 64 + 8) + 8 + 4) == 102448
    # cant_like: 496 slabs, 1,984 CTAs of a whole slab by 128 columns; each
    # warpgroup's 64 columns of B rows padded by 8 floats
    go = slab_launch(512, 496, 128)
    assert (go.lanes, go.cols, go.threads, go.grid) == (128, 128, 256, (1984, 1))
    assert go.smem == 4 * (4 * 32 * (256 + 128 + 16) + 8 + 4) == 204848 <= SMEM_LIMIT
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
    assert slab_launch(512, 40, 8).smem == 4 * (4 * 8 * 200 + 8 + 4)
    with pytest.raises(ValueError, match="block_k % 8"):
        slab_launch(512, 40, 4)
    with pytest.raises(ValueError, match="n >= 1"):
        slab_launch(0, 40, 128)


@pytest.mark.parametrize("cell,tiles", [
    # the cantilever stand-in's 62,451 rows in 61 M-tiles of 1,024: 488 slabs,
    # 1,952 CTAs of a whole slab by 128 columns (the training cell runs A and
    # its transpose, of the same square shape)
    ("cant_mxu_n512.repeat", (128, 128, 256, (488 * 4, 1))),
    ("cant_mxu_n512.train", (128, 128, 256, (488 * 4, 1))),
    # nasa4704's 4,704 rows in 5 M-tiles: 40 slabs, whose 160 whole-slab CTAs
    # would not fill the card four times over, so 640 CTAs of half a slab
    ("nasa4704_mxu_n512.repeat", (64, 64, 128, (40 * 2 * 8, 1))),
])
def test_slab_launch_at_the_mxu_cells(cell, tiles):
    """The tile shape slab_launch picks for K1 in each mxu cell of the
    benchmark (``BENCHMARK.json``, ``bench_torch/configs``): plain mode, N =
    512, block_k 128. Both shapes run the overlapped mainloop."""
    root = Path(__file__).resolve().parent.parent
    bench = json.loads((root / "BENCHMARK.json").read_text())
    config = next(w["config"] for w in bench["workloads"] if w["name"] == cell)
    cfg = json.loads((root / "bench_torch" / "configs" / f"{config}.json").read_text())
    assert cfg["backend"] == "mxu" and cfg["spmm_config"]["block_k"] == 128
    slab = cfg["spmm_config"]
    n_slabs = -(-cfg["rows"] // slab["tile_m"]) * slab["tile_m"] // MSLAB
    go = slab_launch(cfg["n"], n_slabs, slab["block_k"])
    assert (go.lanes, go.cols, go.threads, go.grid) == tiles
    assert go.smem == (204848 if go.threads == 256 else 102448) <= SMEM_LIMIT


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
    via = kernel(*pl.arrays, b_p, c_p, ALPHA, BETA, ranges=pl.ranges, m=pl.m, k=pl.k, **kw)
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


# ---- K6's entry map and its walk ----

def _entry_values(case):
    """(values, offsets, m, k): random values over a case's offsets with
    stored zeros, a NaN entry, a -0.0 (no entry) and an empty row."""
    m, k = (150, 80) if case == "beyond_k" else (203, 230)  # 203: a group past M
    offs = np.array(OFFSET_CASES[case])
    rng = np.random.default_rng(len(offs))
    vals = rng.standard_normal((offs.size, m)).astype(np.float32)
    vals[rng.random(vals.shape) < 0.7] = 0.0
    vals[:, 17] = 0.0  # an empty row
    vals[0, 5] = np.nan
    vals[-1, 6] = -0.0
    return vals, offs, m, k


def _map_entries(ptr, order, slot_ptr, slots, offs, m):
    """The (diagonal, value bits) a map lists for each (run, row), in its
    slot order, and each slot's padding checked: bits 0 and window row 0."""
    groups = order.size // 8
    listed = {}
    for r, (d0, d1) in enumerate(zip(ptr[:-1], ptr[1:])):
        for g in range(groups):
            block = slots[slot_ptr[r * groups + g]:slot_ptr[r * groups + g + 1]]
            for lane in range(8):
                local = int(order[8 * g + lane])
                row, bits, at = 64 * (g // 8) + local, block[:, lane], block[:, 8 + lane]
                held = bits != 0
                # a row's entries first, then its pads
                assert not np.any(held[1:] & ~held[:-1])
                assert np.all(at[~held] == 0)
                if row >= m:
                    assert not held.any()
                rel = at[held] - local
                d = np.searchsorted(offs, offs[d0] + rel)
                assert np.all((d >= d0) & (d < d1)) and np.all(offs[d] == offs[d0] + rel)
                assert np.all(np.diff(d) > 0)  # ascending offsets within the row
                listed[r, row] = list(zip(d.tolist(), bits[held].tolist()))
    return listed


@pytest.mark.parametrize("span_max", [0, 5, DIA_ENTRY_SPAN_MAX])
@pytest.mark.parametrize("case", list(OFFSET_CASES))
def test_dia_entry_map_lists_every_entry_once(case, span_max):
    vals, offs, m, k = _entry_values(case)
    ptr, order, slot_ptr, slots, entries = dia_entry_map(vals, offs, span_max)
    assert ptr.tolist() == dia_runs(offs, span_max).tolist()
    tiles = -(-m // 64)
    groups = 8 * tiles
    assert order.dtype == np.uint8 and order.shape == (64 * tiles,)
    held = np.full(64 * tiles, -1)
    held[:m] = np.count_nonzero(vals, axis=0)
    for t in range(tiles):  # a tile's rows, each once, the fullest first
        assert sorted(order[64 * t:64 * t + 64].tolist()) == list(range(64))
        assert np.all(np.diff(held[64 * t + order[64 * t:64 * t + 64].astype(int)]) <= 0)
    assert slot_ptr.dtype == slots.dtype == np.int32 and slots.shape == (slot_ptr[-1], 16)
    assert slot_ptr.shape == ((ptr.size - 1) * groups + 1,) and np.all(np.diff(slot_ptr) >= 0)
    listed = _map_entries(ptr, order, slot_ptr, slots, offs, m)
    bits = vals.view(np.int32)
    want = {(d, i) for d, i in zip(*np.nonzero(vals != 0))}  # NaN held, -0.0 not
    got = [(d, row) for (r, row), run in listed.items() for d, _ in run]
    assert len(got) == len(set(got)) == entries == len(want) and set(got) == want
    assert all(bits[d, row] == b for (r, row), run in listed.items() for d, b in run)
    assert (0, 5) in want and (offs.size - 1, 6) not in want and not any(i == 17 for _, i in want)
    # each group takes as many slots a run as its fullest row has entries
    place = {64 * (g // 8) + int(order[8 * g + j]): g for g in range(groups) for j in range(8)}
    for (r, row), run in listed.items():
        g = place[row]
        mates = [64 * (g // 8) + int(order[8 * g + j]) for j in range(8)]
        fullest = max(len(listed.get((r, mate), [])) for mate in mates)
        assert slot_ptr[r * groups + g + 1] - slot_ptr[r * groups + g] == fullest
    # the map lists entries whose B row lies outside [0, K) as any other
    if case == "beyond_k":
        assert any(not 0 <= i + offs[d] < k for d, i in want)
    # a map past `within` slots is not made
    assert dia_entry_map(vals, offs, span_max, within=slots.shape[0] - 1) is None
    assert dia_entry_map(vals, offs, span_max, within=slots.shape[0])[4] == entries


def test_dia_entries_are_held_to_their_dvals_and_runs():
    vals, offs, m, k = _entry_values("gapped")
    dv = torch.from_numpy(vals)
    runs = dia_plan(offs, "cpu")
    walk = dia_entries(dv, runs.offsets)
    assert walk.dvals is dv and walk.runs.offsets is runs.offsets
    assert walk.runs.ptr.tolist() == dia_runs(offs, DIA_ENTRY_SPAN_MAX).tolist()
    assert walk.entries == np.count_nonzero(vals)
    b = torch.from_numpy(np.random.default_rng(0).standard_normal((k, 8)).astype(np.float32))
    c = torch.ones((m, 8))
    want = spmm_dia_ref(dv, runs.offsets, b, c, ALPHA, BETA)
    got = spmm_dia(dv, runs.offsets, b, c, ALPHA, BETA, runs=runs, entries=walk)
    assert torch.equal(got.nan_to_num(), want.nan_to_num())
    # a map of other values would skip their entries: refused, on any device
    with pytest.raises(ValueError, match="entries.dvals"):
        spmm_dia(dv.clone(), runs.offsets, b, c, ALPHA, BETA, runs=runs, entries=walk)
    with pytest.raises(ValueError, match="entries.runs.offsets"):
        spmm_dia(dv, runs.offsets.clone(), b, c, ALPHA, BETA, entries=walk)
    # a map is held to its run plan's windows and its tiles on the host,
    # before it is uploaded; on its device, to its arrays' types and shapes
    ptr, order, slot_ptr, slots, _ = dia_entry_map(vals, offs)
    assert check_entry_map(ptr, order, slot_ptr, slots, offs, m) == walk.tile_slots
    bad = slots.copy()
    bad[0, 8] = 64 + offs[ptr[1] - 1] - offs[0]  # one row past the first run's window
    with pytest.raises(ValueError, match="past its run's window"):
        check_entry_map(ptr, order, slot_ptr, bad, offs, m)
    twice = order.copy()
    twice[1] = twice[0]
    with pytest.raises(ValueError, match="each row of a tile once"):
        check_entry_map(ptr, twice, slot_ptr, slots, offs, m)
    with pytest.raises(ValueError, match="slot_ptr"):
        check_entry_map(ptr, order, slot_ptr[:-1], slots, offs, m)
    with pytest.raises(ValueError, match="slot_ptr must cut"):
        check_entry_map(ptr, order, slot_ptr[::-1].copy(), slots, offs, m)
    with pytest.raises(ValueError, match="slots must be torch.int32"):
        DiaEntries(dv, walk.runs, walk.order, walk.slot_ptr, walk.slots.float(), walk.entries,
                   walk.tile_slots)


def test_dia_entry_launch_map():
    # scircuit_like's -60..60 in one run: 64 + 120 rows of B a tile, no
    # dvals, four CTAs an SM
    vals = np.ones((121, 170998), dtype=np.float32)
    vals[:, ::3] = 0.0
    walk = dia_entries(torch.from_numpy(vals),
                       dia_plan(np.arange(-60, 61), "cpu").offsets, vals)
    assert walk.runs.ptr.tolist() == [0, 121] and walk.runs.span == 120
    go = dia_entry_launch(512, 170998, walk, 4)
    assert (go.threads, go.grid, go.cols) == (128, (21376, 1), 4)
    # beside the window, a tile's slots as far as four CTAs an SM allow: two
    # rows in three are full, 42 or 43 of a tile, so six groups of 121 slots
    assert walk.tile_slots == 6 * 121 and go.lanes == (57344 - 47104) // 64 == 160
    assert go.smem == 4 * (64 + 120) * 64 + 64 * go.lanes == 57344
    assert 4 * (go.smem + 1024) <= 228 * 1024
    none = np.zeros_like(vals)
    empty = dia_entries(torch.from_numpy(none), walk.runs.offsets, none)
    assert empty.tile_slots == 0 and empty.entries == 0
    assert dia_entry_launch(37, 170998, empty, 1).smem == 4 * (64 + 120) * 16


def _entry_walk(dvals, offsets, b, c, host_map, precise, tn=64):
    """K6's entry walk over the map: per (64-row tile, run, TN columns) the
    window of B rows row0 + off_first .. row0 + 63 + off_last, zero outside
    [0, K); where it is all finite, a group's slots in order, each of its
    rows (``order``) one FFMA (precise: two_prod and a Neumaier step) with
    its slot's value and window row; else the run's every diagonal from
    dvals; the epilogue."""
    ptr, order, slot_ptr, slots, _ = host_map
    n_diags, m = dvals.shape
    k, n = b.shape
    offs = offsets.tolist()
    groups = order.size // 8
    vals = torch.from_numpy(slots[:, :8].copy().view(np.float32))
    at = torch.from_numpy(slots[:, 8:].astype(np.int64))
    out_acc, out_comp = torch.zeros((m, n)), torch.zeros((m, n))
    dv = torch.cat([dvals, torch.zeros((n_diags, DIA_TILE_ROWS))], dim=1)  # 0 past M
    for row0 in range(0, m, DIA_TILE_ROWS):
        for col0 in range(0, n, tn):
            cols = slice(col0, min(n, col0 + tn))
            acc = torch.zeros((DIA_TILE_ROWS, cols.stop - col0))
            comp = torch.zeros_like(acc)

            def step(rows, v, x):
                nonlocal acc, comp
                if precise:
                    acc[rows], comp[rows] = acc_step(acc[rows], comp[rows], *two_prod(v, x))
                else:
                    acc[rows] = fma_f32(v, x, acc[rows])

            for r, (d0, d1) in enumerate(zip(ptr[:-1], ptr[1:])):
                off0, last = offs[d0], offs[d1 - 1] - offs[d0]
                grow = row0 + off0 + np.arange(DIA_TILE_ROWS + last)
                inside = (grow >= 0) & (grow < k)
                win = torch.zeros((grow.size, acc.shape[1]))
                win[torch.from_numpy(inside)] = b[torch.from_numpy(grow[inside]), cols]
                if not torch.isfinite(win).all():
                    for d in range(d0, d1):
                        rel = offs[d] - off0
                        step(slice(None), dv[d, row0:row0 + DIA_TILE_ROWS, None],
                             win[rel:rel + DIA_TILE_ROWS])
                    continue
                for g in range(row0 // 8, row0 // 8 + DIA_TILE_ROWS // 8):
                    rows = torch.from_numpy(order[8 * g:8 * g + 8].astype(np.int64))
                    for s in range(slot_ptr[r * groups + g], slot_ptr[r * groups + g + 1]):
                        step(rows, vals[s, :, None], win[at[s]])
            keep = min(DIA_TILE_ROWS, m - row0)
            out_acc[row0:row0 + keep, cols] = acc[:keep]
            out_comp[row0:row0 + keep, cols] = comp[:keep]
    if precise:
        return compensated_epilogue(ALPHA, out_acc, out_comp, BETA, c)
    return fma_f32(torch.full_like(out_acc, f32(ALPHA)), out_acc, c * f32(BETA))


def _entry_split(kind):
    if kind == "band":  # a stencil's 7 diagonals, 97 % of their slots full
        return tx.split_structure(stencil_3d(12, seed=1), n=16)
    if kind == "synthetic":  # 256 gapped diagonals in -288..300, 4 % full
        return tx.split_structure(tx.COOMatrix.random(4704, 4704, 104756, seed=42,
                                                      banded=True, bandwidth=300), n=512)
    return tx.split_structure(circuit_like(3000, seed=2), n=64)  # -60..60, 4 % full; full


@pytest.mark.parametrize("poison", [None, float("nan"), float("inf")])
@pytest.mark.parametrize("precise", [0, 1])
@pytest.mark.parametrize("kind", ["band", "synthetic", "circuit"])
def test_dia_entry_walk_gives_the_plain_versions_bits(kind, precise, poison):
    split = _entry_split(kind)
    n = 5
    rng = np.random.default_rng(3)
    values = split.diag_vals.copy()
    d, i = values.shape[0] // 2, split.m // 2
    values[d, i] = 0.0  # a stored zero that reads B's middle row
    dvals = torch.from_numpy(values)
    offsets = torch.from_numpy(split.diag_offsets.astype(np.int32))
    b = torch.from_numpy(rng.standard_normal((split.k, n)).astype(np.float32))
    c = torch.from_numpy(rng.standard_normal((split.m, n)).astype(np.float32))
    if poison is not None:
        b[i + split.diag_offsets[d], 1] = poison
    host_map = dia_entry_map(values, split.diag_offsets)
    got = _entry_walk(dvals, offsets, b, c, host_map, precise, tn=4)
    want = spmm_dia_ref(dvals, offsets, b, c, ALPHA, BETA, precise=precise)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert bool(torch.isnan(want).any()) == (poison is not None)
    assert torch.equal(got.nan_to_num(), want.nan_to_num())


@pytest.mark.parametrize("precise", [0, 1])
@pytest.mark.parametrize("kind", ["band", "synthetic", "circuit", "full"])
def test_hybrid_plan_walks_the_entries_where_that_pays(kind, precise):
    # the plan's own counts choose: in plain mode a band of 121 consecutive
    # diagonals that are full keeps the dense walk; splits whose diagonals
    # are 4 % full, and a stencil's 7 (27 steps of the dense walk), take the
    # entry walk; in precise mode every split takes it
    split = _entry_split(kind)
    if kind == "full":
        split.diag_vals = np.random.default_rng(2).standard_normal(
            split.diag_vals.shape).astype(np.float32)
    walks = kind != "full" or bool(precise)
    limit = entry_walk_slots(split.diag_offsets, split.m, precise)
    assert (limit is None) == bool(precise)
    n = 40  # K6 (N > 32); on the CPU its plain version
    before = tx.counters().get("dia.walk_entries", 0)
    plan = tx.HybridSpmmPlan(split, n, dia_backend="pallas", device="cpu", precise=precise,
                             residue_config=tx.SpmmConfig(), residue_fmt="vpu")
    walk = plan._dia_kw.get("entries")
    assert (walk is not None) == walks
    assert tx.counters().get("dia.walk_entries", 0) == before + (split.diag_nnz if walks else 0)
    if walks:
        assert walk.dvals is plan._dvals and walk.runs.offsets is plan._offsets
    rng = np.random.default_rng(5)
    b = rng.standard_normal((split.k, n)).astype(np.float32)
    c = rng.standard_normal((split.m, n)).astype(np.float32)
    got = plan(b, ALPHA, BETA, c)
    plan._dia_kw.pop("entries", None)  # the dense walk's plan
    assert torch.equal(got, plan(b, ALPHA, BETA, c))
