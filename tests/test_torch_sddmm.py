"""The host plan and the arithmetic order of the SDDMM kernel
(``csrc/sddmm.cu``), on the CPU.

* ``sddmm_tiles`` takes A's entries in CSR order (``perm`` None exactly when
  the COO is already in it), puts every entry in exactly one tile, and gives
  each tile a complete list of its distinct rows and distinct columns within
  the kernel's ring, each entry's two slots pointing at its own row and
  column; a row longer than a tile is spread over tiles; rows with the same
  columns share a tile, so a finite-element node's B rows are staged once
  for its three dofs; short rows fill a tile toward the ring.
* A walk of the kernel's arithmetic over the plan (``sddmm_rows_walk``)
  matches the plain SDDMM within 4 ulp of max|dvals|, and exactly on
  integer-valued inputs, at N from 1 to 600.
"""

import torch_cpu  # noqa: F401  one torch thread per xdist worker

import numpy as np
import pytest
import torch

import sextans_tpu_torch as tx
from sextans_tpu_torch.ops.sddmm import (
    SDDMM_RING_ROWS,
    SDDMM_TILE_ENTRIES,
    sddmm_launch,
    sddmm_plan,
    sddmm_rows,
    sddmm_rows_ref,
    sddmm_rows_walk,
    sddmm_tiles,
)
from sextans_tpu_torch.utils.matrices import fem_like


def _coo(shape, rows, cols):
    rows, cols = np.asarray(rows), np.asarray(cols)
    return tx.COOMatrix(shape, rows, cols, np.ones(rows.size, np.float32))


def _matrix(kind):
    rng = np.random.default_rng(5)
    if kind == "fem":
        return fem_like(300, dofs=3, neighbors=5, seed=2)
    if kind == "random":
        return tx.COOMatrix.random(200, 150, 3000, seed=1)
    if kind == "duplicates":  # ~3 entries a coordinate
        return _coo((40, 50), rng.integers(0, 40, 6000), rng.integers(0, 50, 6000))
    if kind == "empty_rows":  # only every third row holds entries
        return _coo((300, 80), 3 * rng.integers(0, 100, 2000), rng.integers(0, 80, 2000))
    if kind == "empty":
        return _coo((30, 20), [], [])
    if kind == "rectangular":
        return tx.COOMatrix.random(20, 3000, 4000, seed=2)
    if kind == "long_row":  # row 1 holds 1,000 distinct columns, past any tile
        k = 1000
        rows = np.concatenate([np.full(k, 1), [0, 0, 2, 4, 4]])
        cols = np.concatenate([np.arange(k), [3, 999, 0, 5, 7]])
        return _coo((5, k), rows, cols)
    raise ValueError(kind)


KINDS = ["fem", "random", "duplicates", "empty_rows", "empty", "rectangular", "long_row"]


def _ordered(a, order):
    """``a`` in CSR order, or its entries shuffled."""
    if order == "sorted":
        return a.sorted_by_row()
    p = np.random.default_rng(9).permutation(a.nnz)
    return tx.COOMatrix(a.shape, a.rows[p], a.cols[p], a.vals[p])


def _lexsorted(a) -> bool:
    key = a.rows.astype(np.int64) * a.shape[1] + a.cols
    return bool(np.all(np.diff(key) >= 0))


@pytest.mark.parametrize("order", ["sorted", "shuffled"])
@pytest.mark.parametrize("kind", KINDS)
def test_sddmm_tiles_cover_every_entry_once(kind, order):
    a = _ordered(_matrix(kind), order)
    t = sddmm_tiles(a.rows, a.cols, a.shape)
    nnz = a.nnz
    assert (t.perm is None) == _lexsorted(a)
    perm = np.arange(nnz) if t.perm is None else t.perm.astype(np.int64)
    assert np.array_equal(np.sort(perm), np.arange(nnz))  # every entry exactly once
    rows, cols = a.rows[perm].astype(np.int64), a.cols[perm].astype(np.int64)
    assert np.all(np.diff(rows * a.shape[1] + cols) >= 0)  # CSR order
    n_tiles = t.tile_rows.size
    assert t.tile_ptr[0] == 0 and t.tile_ptr[-1] == nnz and np.all(np.diff(t.tile_ptr) > 0)
    assert t.slot_ptr.size == n_tiles + 1 and t.slot_ptr[-1] == t.slots.size
    assert t.shape == a.shape
    if nnz == 0:
        assert n_tiles == 0 and t.ring_rows == 0
        return
    assert np.diff(t.tile_ptr).max() <= SDDMM_TILE_ENTRIES
    assert t.ring_rows == np.diff(t.slot_ptr).max() <= SDDMM_RING_ROWS
    for i in range(n_tiles):
        e0, e1 = t.tile_ptr[i], t.tile_ptr[i + 1]
        slots = t.slots[t.slot_ptr[i]:t.slot_ptr[i + 1]]
        n_g = t.tile_rows[i]
        g_slot, b_slot = t.codes[e0:e1] & 0xFFFF, t.codes[e0:e1] >> 16
        assert np.all(g_slot < n_g) and np.all(b_slot >= n_g) and np.all(b_slot < slots.size)
        # each entry's slots hold its own row and column
        assert np.array_equal(slots[g_slot], rows[e0:e1])
        assert np.array_equal(slots[b_slot], cols[e0:e1])
        # the lists are complete and distinct: exactly the tile's rows and columns
        assert np.array_equal(np.sort(slots[:n_g]), np.unique(rows[e0:e1]))
        assert np.array_equal(np.sort(slots[n_g:]), np.unique(cols[e0:e1]))


def test_sddmm_tiles_spread_a_long_row_over_tiles():
    a = _matrix("long_row")
    t = sddmm_tiles(a.rows, a.cols, a.shape)
    tile_of = np.repeat(np.arange(t.tile_rows.size), np.diff(t.tile_ptr))
    row1 = tile_of[a.rows == 1]
    assert np.unique(row1).size >= -(-1000 // SDDMM_RING_ROWS)
    assert np.all(np.diff(row1) >= 0)  # contiguous slices, in order


def test_sddmm_tiles_stage_a_nodes_columns_once():
    """A finite-element node's three dofs share their columns: each B row a
    tile stages serves three entries or more (more where a tile holds two
    nodes with columns in common), and the counters say so."""
    a = fem_like(600, dofs=3, neighbors=22, bandwidth=661, seed=13)
    before = tx.counters()
    t = sddmm_tiles(a.rows, a.cols, a.shape)
    after = tx.counters()
    entries = after["sddmm.entries"] - before.get("sddmm.entries", 0)
    b_rows = after["sddmm.b_rows"] - before.get("sddmm.b_rows", 0)
    assert entries == a.nnz
    assert b_rows == np.sum(np.diff(t.slot_ptr) - t.tile_rows)
    assert entries >= 3 * b_rows
    assert np.all(t.tile_rows % 3 == 0)


@pytest.mark.parametrize("per_row", [2, 4, 8])
def test_sddmm_tiles_pack_short_rows_toward_the_ring(per_row):
    """Rows with no columns in common are units of one row; the bins follow
    the largest unit A has, so a tile takes as many rows as the ring allows
    less that unit: at least half the ring's slots on average."""
    m = 3000
    a = tx.COOMatrix.random(m, m, m * per_row, seed=per_row)
    t = sddmm_tiles(a.rows, a.cols, a.shape)
    slots = np.diff(t.slot_ptr)
    rlen = np.bincount(a.rows, minlength=m)
    assert t.tile_rows.sum() == np.count_nonzero(rlen)  # no row of these is cut
    assert slots.mean() >= SDDMM_RING_ROWS / 2
    assert slots.max() <= SDDMM_RING_ROWS


@pytest.mark.parametrize("n,vec,lanes", [(1, 1, 1), (3, 1, 4), (16, 4, 4), (40, 4, 8),
                                         (40, 1, 8), (512, 4, 8), (600, 4, 8)])
def test_sddmm_launch_lanes_follow_n(n, vec, lanes):
    go = sddmm_launch(n, vec, n_tiles=7)
    assert (go.lanes, go.cols, go.threads, go.grid) == (lanes, vec, 128, (7, 1))


def _operands(a, n, integer, seed=0):
    rng = np.random.default_rng(seed)
    m, k = a.shape
    if integer:
        g, b = rng.integers(-3, 4, (m, n)), rng.integers(-3, 4, (k, n))
    else:
        g, b = rng.standard_normal((m, n)), rng.standard_normal((k, n))
    return torch.tensor(g, dtype=torch.float32), torch.tensor(b, dtype=torch.float32)


@pytest.mark.parametrize("integer", [False, True])
@pytest.mark.parametrize("n", [1, 16, 40, 600])
@pytest.mark.parametrize("kind,order", [("fem", "sorted"), ("duplicates", "shuffled"),
                                        ("empty_rows", "shuffled"), ("empty", "sorted"),
                                        ("rectangular", "sorted"), ("long_row", "shuffled")])
def test_sddmm_walk_matches_the_plain_version(kind, order, n, integer):
    a = _ordered(_matrix(kind), order)
    g, b = _operands(a, n, integer)
    rows = torch.as_tensor(a.rows.astype(np.int64))
    cols = torch.as_tensor(a.cols.astype(np.int64))
    want = sddmm_rows_ref(g, b, rows, cols)
    got = sddmm_rows_walk(sddmm_tiles(a.rows, a.cols, a.shape), g, b, 4 if n % 4 == 0 else 1)
    assert got.shape == want.shape == (a.nnz,)
    if integer or a.nnz == 0:
        assert torch.equal(got, want)
        return
    exact = (g.double()[rows] * b.double()[cols]).sum(dim=1)
    unit = np.spacing(np.float32(exact.abs().max().item()))
    assert (got - want).abs().max().item() <= 4 * unit
    assert (got.double() - exact).abs().max().item() <= 4 * unit


def test_sddmm_rows_on_the_cpu_is_the_plain_version():
    a = _ordered(_matrix("duplicates"), "shuffled")
    g, b = _operands(a, 24, integer=False, seed=3)
    rows = torch.as_tensor(a.rows.astype(np.int64))
    cols = torch.as_tensor(a.cols.astype(np.int64))
    assert sddmm_plan(a.rows, a.cols, a.shape, torch.device("cpu")) is None
    assert torch.equal(sddmm_rows(g, b, rows, cols), sddmm_rows_ref(g, b, rows, cols))
    assert tx.spmm_value_op(a, 24, fmt="ell", device="cpu").sddmm_tiles is None


def test_sddmm_tiles_refuse_an_entry_outside_the_matrix():
    with pytest.raises(ValueError, match="outside"):
        sddmm_tiles(np.array([0, 4]), np.array([1, 2]), (4, 3))
    with pytest.raises(ValueError, match="outside"):
        sddmm_tiles(np.array([0, 1]), np.array([1, 3]), (4, 3))
