"""The host scan and the arithmetic order of the ELL gather kernel (K5), on
the CPU.

* ``ell_tiles`` lists every padded row once, in logical order (a real row,
  then its virtual rows in fold-table order; pad rows alone), and cuts that
  list into tiles of whole logical rows: runs of up to ``group_max``
  logical rows with the same ``cols``, padded row by padded row, where such
  runs hold two or more on average, else one a tile; a logical row of more
  than ``ELL_LONG_ROWS`` padded rows is cut into tiles of one row and listed
  for the second fold.
* A walk of the kernel's arithmetic over the scan (per tile and column,
  each member's padded rows in order, each one's FFMA chain in slot order
  over the B rows of member 0's columns, value-0 slots dropped; the
  epilogue; the fold of each member's virtual rows in registers, in f32 or
  f64 in precise mode; then the long rows' fold) gives
  ``spmm_ell_gather_padded_ref``'s bits, plain and precise, with and without
  C, with a non-finite B row that only value-0 slots read, and through
  ``repeat``.
* Both stay within the tolerance of ``tests/test_torch_ell.py`` of the JAX
  package's ``ell_pallas`` interpret route and its ``ell`` engine.
"""

import torch_cpu  # noqa: F401  one torch thread per xdist worker

import dataclasses

import numpy as np
import pytest
import torch

import sextans_tpu_torch as tx
from sextans_tpu.format.coo import COOMatrix as RefCOO
from sextans_tpu.format.csr import CSRMatrix as RefCSR
from sextans_tpu.format.pack_ell import pack_ell as ref_pack_ell
from sextans_tpu.ops.golden import golden_spmm_exact
from sextans_tpu.ops.plan import SpmmPlan as RefPlan
from sextans_tpu.utils.config import SpmmConfig as RefConfig
from sextans_tpu_torch.format.convert import from_reference
from sextans_tpu_torch.ops.df32 import acc_step, compensated_epilogue, two_prod
from sextans_tpu_torch.ops.launch import f32, fma_f32, rank_groups
from sextans_tpu_torch.ops.serve import bucketize_pack
from sextans_tpu_torch.ops.spmm_ell import (
    ELL_GROUP_MAX,
    ELL_LONG_ROWS,
    ELL_VEC4_MIN_N,
    EllTiles,
    ell_fold_count,
    ell_launch,
    ell_tiles,
    spmm_ell_gather_padded,
    spmm_ell_gather_padded_ref,
)
from sextans_tpu_torch.utils.matrices import fem_like
from sextans_tpu_torch.utils.profiling import launches

ALPHA, BETA = 0.85, -2.06


def _hub_coo(m=1030, k=777, seed=5):
    # rows 5 and 600 hold 300 nonzeros each (tests/test_torch_gpu.py:_hub_matrix)
    rng = np.random.default_rng(seed)
    rows = np.concatenate([np.full(300, 5), np.full(300, 600), rng.integers(0, m, 4000)])
    cols = rng.integers(0, k, rows.size)
    vals = rng.standard_normal(rows.size).astype(np.float32)
    return RefCOO((m, k), rows, cols, vals)


def _wide_row_coo():
    # row 7 over every column: its logical row reads more B rows than a tile stages
    coo = _hub_coo()
    return RefCOO(coo.shape, np.concatenate([coo.rows, np.full(777, 7)]),
                  np.concatenate([coo.cols, np.arange(777)]),
                  np.concatenate([coo.vals, np.linspace(-1, 1, 777, dtype=np.float32) + 0.01]))


def _fem_coo():
    # 3 dofs a node: each node's rows share their columns, in groups of three
    coo = fem_like(600, dofs=3, neighbors=7, bandwidth=60, seed=4)
    return RefCOO(coo.shape, coo.rows, coo.cols, coo.vals)


def _pack(kind):
    """A port pack carried over from the JAX package's ``pack_ell`` (the
    scan's input), changed by hand where the case asks for it."""
    coo = {"hub_r4": _hub_coo, "hub_r8": _hub_coo, "wide_row": _wide_row_coo, "fem": _fem_coo,
           "banded": lambda: RefCOO.random(300, 260, 3000, seed=2, banded=True,
                                           bandwidth=40)}[kind.split("+")[0]]()
    r = {"hub_r4": 4, "hub_r8": 8, "wide_row": 32, "banded": 8, "fem": 8}[kind.split("+")[0]]
    ref = ref_pack_ell(coo, RefConfig(tile_m=64), slots_per_row=r)
    port = from_reference(ref)
    if kind.endswith("+reversed"):  # every row's live slots descend
        port.cols, port.vals = port.cols[:, ::-1].copy(), port.vals[:, ::-1].copy()
    if kind.endswith("+shuffled"):  # one slot order per row, drawn at random
        rng = np.random.default_rng(11)
        perm = np.argsort(rng.random(port.cols.shape), axis=1)
        port.cols = np.take_along_axis(port.cols, perm, 1)
        port.vals = np.take_along_axis(port.vals, perm, 1)
    if kind.endswith("+permuted"):  # fold_rows out of order
        m, nv = port.m_base, port.n_virt
        perm = np.random.default_rng(7).permutation(nv)
        for name in ("cols", "vals"):
            arr = getattr(port, name).copy()
            arr[m:m + nv] = arr[m + perm]
            setattr(port, name, arr)
        port.fold_rows = port.fold_rows[perm].copy()
    return coo, ref, port


KINDS = ["hub_r4", "hub_r8", "banded", "wide_row", "fem", "fem+reversed", "hub_r8+reversed",
         "hub_r8+shuffled", "hub_r8+permuted", "hub_r4+permuted"]


def _logical_order(port):
    """The padded rows in logical order, and each one's logical row, by a
    plain loop over the fold table."""
    virt = {}
    for j, i in enumerate(port.fold_rows):
        virt.setdefault(int(i), []).append(port.m_base + j)
    order, logical = [], []
    for i in range(port.m_base):
        order += [i] + virt.get(i, [])
        logical += [i] * (1 + len(virt.get(i, [])))
    pads = range(port.m_base + port.n_virt, port.m_padded)
    order += list(pads)
    logical += list(range(port.m_base, port.m_base + len(pads)))
    return np.array(order), np.array(logical)


def _logical_rows(port):
    """Each logical row's padded rows, real row first, by a plain loop."""
    virt = {}
    for j, i in enumerate(port.fold_rows):
        virt.setdefault(int(i), []).append(port.m_base + j)
    return ([[i] + virt.get(i, []) for i in range(port.m_base)]
            + [[p] for p in range(port.m_base + port.n_virt, port.m_padded)])


@pytest.mark.parametrize("kind", KINDS)
def test_ell_tiles_hold_whole_logical_rows_that_read_the_same_b_rows(kind):
    _, _, port = _pack(kind)
    t = ell_tiles(port)
    assert all(a.dtype == np.int32 for a in t[:-1])
    logical = _logical_rows(port)
    order = [p for rows in logical for p in rows]
    assert np.array_equal(t.rows, order)  # every padded row once, in logical order
    ptr = t.tile_ptr.astype(np.int64)
    assert ptr[0] == 0 and ptr[-1] == port.m_padded and np.all(np.diff(ptr) >= 1)
    assert t.members.size == ptr.size - 1 and t.members.min() >= 1
    assert t.group_max == t.members.max() <= ELL_GROUP_MAX
    long = {rows[0] for rows in logical if len(rows) > ELL_LONG_ROWS}
    assert set(t.long_rows.tolist()) == long
    for q, i in enumerate(t.long_rows):  # the long rows' virtual rows, in fold order
        want = port.m_base + np.flatnonzero(port.fold_rows == i)
        assert np.array_equal(t.long_virt[t.long_ptr[q]:t.long_ptr[q + 1]], want)
    # walk the tiles over the logical rows
    li = 0
    starts = np.cumsum([0] + [len(rows) for rows in logical])
    for s0, s1, g in zip(ptr[:-1], ptr[1:], t.members):
        if len(logical[li]) > ELL_LONG_ROWS:  # a long row: a tile a padded row
            assert g == 1 and s1 - s0 == 1
            if s1 == starts[li + 1]:
                li += 1
            continue
        assert s0 == starts[li] and s1 == starts[li + g]  # whole logical rows
        size = len(logical[li])
        assert all(len(logical[li + q]) == size for q in range(g))
        for q in range(1, g):  # the same columns, padded row by padded row
            assert np.array_equal(port.cols[logical[li + q]], port.cols[logical[li]])
        li += g
    assert li == len(logical)
    if kind == "hub_r4":
        assert t.long_rows.size == 2  # rows 5 and 600: 75 padded rows each
    if kind.startswith("fem"):
        assert t.group_max == 3 and t.members.mean() > 2.5  # a node's three dofs
    if kind in ("banded", "hub_r8"):
        assert t.group_max == 1  # rows that do not repeat their columns


def test_ell_tiles_runs_are_cut_at_group_max_and_kept_where_they_pay():
    _, _, port = _pack("fem")
    logical = _logical_rows(port)
    # runs of three dofs cut at 2 hold 1.5 logical rows a tile: not kept
    assert ell_tiles(port, group_max=2).group_max == 1
    for cap in (1, 3):
        t = ell_tiles(port, group_max=cap)
        assert t.group_max == cap
        # a tile short of the cap ends where the next logical row differs
        starts = np.cumsum([0] + [len(rows) for rows in logical])
        ends = {int(e): q for q, e in enumerate(starts)}
        for s1, g in zip(t.tile_ptr[1:-1], t.members[:-1]):
            q = ends[int(s1)]
            if g < cap and len(logical[q]) == len(logical[q - 1]):
                assert not np.array_equal(port.cols[logical[q]], port.cols[logical[q - 1]])
    # banded rows seldom repeat: grouping would not pay, one logical row a tile
    _, _, banded = _pack("banded")
    t = ell_tiles(banded)
    assert t.group_max == 1 and t.tile_ptr.size - 1 == len(_logical_rows(banded))
    with pytest.raises(ValueError, match="positive"):
        ell_tiles(port, group_max=0)


def _walk(port, t: EllTiles, b, c, alpha, beta, *, with_c, precise):
    """K5's arithmetic over the scan, as the kernel orders it: each padded
    row's chain in slot order over the B rows of its tile's member 0 at the
    same padded row (a value-0 slot's product dropped); its epilogue; each
    member's virtual rows folded into its real row's sum in order (rank by
    rank here: a rank touches each real row once); then the long rows'
    fold. C and the output have the rows ``c`` has: a padded row past them
    takes no C term and keeps its sum for the fold alone."""
    m_padded, r_slots = port.vals.shape
    ptr = t.tile_ptr.astype(np.int64)
    rows = t.rows.astype(np.int64)
    sizes = np.diff(ptr) // t.members  # padded rows of each member
    start = np.repeat(ptr[:-1], np.diff(ptr))
    at = np.arange(m_padded) - start  # position in the tile
    size = np.repeat(sizes, np.diff(ptr))
    rank = at % size  # padded row of the member: 0 its real row
    lead = rows[start + rank]  # member 0's padded row at that rank
    real = rows[start + at // size * size]
    vals = torch.from_numpy(port.vals[rows])
    lead_cols = torch.from_numpy(port.cols[lead].astype(np.int64))
    acc = torch.zeros((m_padded, b.shape[1]), dtype=torch.float32)
    comp = torch.zeros_like(acc)
    for r in range(r_slots):
        v = vals[:, r, None]
        live = v != 0
        x = b[lead_cols[:, r]]
        if precise:
            s_, e_ = acc_step(acc, comp, *two_prod(v, x))
            acc, comp = torch.where(live, s_, acc), torch.where(live, e_, comp)
        else:
            acc = torch.where(live, fma_f32(v, x, acc), acc)
    kept = torch.from_numpy(rows < c.shape[0])  # the padded rows that C and out hold
    has_c = kept[:, None] & with_c
    cp = torch.zeros_like(acc)
    cp[kept] = c[torch.from_numpy(rows)[kept]]
    if precise:
        o = torch.where(has_c, compensated_epilogue(alpha, acc, comp, beta, cp),
                        compensated_epilogue(alpha, acc, comp))
    else:
        o = torch.where(has_c, fma_f32(torch.full_like(acc, f32(alpha)), acc, cp * f32(beta)),
                        acc * f32(alpha))
    add = o.double() if precise else o.clone()
    add = torch.where(has_c, add - (cp.double() if precise else cp) * f32(beta), add)
    out = torch.empty((c.shape[0], b.shape[1]), dtype=torch.float32)
    out[torch.from_numpy(rows)[kept]] = o[kept]
    sums = {}

    def fold(i, a):
        sums[i] = (sums[i] if i in sums else (out[i].double() if precise else out[i])) + a

    for q in range(1, int(rank.max(initial=0)) + 1):  # the folds, rank by rank
        sel = np.flatnonzero(rank == q)
        for i, a in zip(real[sel].tolist(), add[sel]):
            fold(i, a)
    for q, i in enumerate(t.long_rows.tolist()):
        for v in t.long_virt[t.long_ptr[q]:t.long_ptr[q + 1]].tolist():
            fold(i, add[int(np.flatnonzero(rows == v)[0])])
    for i, a in sums.items():
        out[i] = a.float()
    return out


def _operands(port, n, seed=0, nonfinite=None):
    rng = np.random.default_rng(seed)
    b = torch.from_numpy(rng.standard_normal((port.k, n)).astype(np.float32))
    c = torch.from_numpy(rng.standard_normal((port.m_padded, n)).astype(np.float32))
    if nonfinite is not None:
        b[nonfinite] = float("nan")
    return b, c


def _ref(port, b, c, **kw):
    arrays = [torch.from_numpy(np.ascontiguousarray(a)) for a in
              (port.vals, port.cols.astype(np.int32), port.fold_rows.astype(np.int32))]
    return spmm_ell_gather_padded_ref(*arrays, b, c, ALPHA, BETA if kw["with_c"] else 0.0,
                                      m_base=port.m_base, **kw)


@pytest.mark.parametrize("precise", [0, 1])
@pytest.mark.parametrize("with_c", [True, False])
@pytest.mark.parametrize("kind", KINDS)
def test_walk_over_tiles_gives_the_plain_versions_bits(kind, with_c, precise):
    _, _, port = _pack(kind)
    t = ell_tiles(port)
    b, c = _operands(port, 12)
    want = _ref(port, b, c, with_c=with_c, precise=precise)
    got = _walk(port, t, b, c, ALPHA, BETA if with_c else 0.0, with_c=with_c,
                precise=precise)
    assert torch.equal(got, want)


@pytest.mark.parametrize("precise", [0, 1])
@pytest.mark.parametrize("with_c", [True, False])
@pytest.mark.parametrize("kind", KINDS)
def test_walk_in_place_gives_the_plain_versions_bits(kind, with_c, precise):
    """C and the output at the real rows (``SpmmPlan.__call__``): the walk
    gives the plain version's bits, and the padded route's values on the
    real rows (the virtual rows' o without a C term is the zero pad's, up
    to the sign of a zero)."""
    _, _, port = _pack(kind)
    t = ell_tiles(port)
    b, c = _operands(port, 12)
    c_real = c[:port.m_base].clone()
    want = _ref(port, b, c_real, with_c=with_c, precise=precise)
    assert want.shape == (port.m_base, 12)
    got = _walk(port, t, b, c_real, ALPHA, BETA if with_c else 0.0, with_c=with_c,
                precise=precise)
    assert torch.equal(got, want)
    c_pad = torch.cat([c_real, torch.zeros((port.m_padded - port.m_base, 12))])
    padded = _ref(port, b, c_pad, with_c=with_c, precise=precise)
    assert torch.equal(want, padded[:port.m_base])


@pytest.mark.parametrize("precise", [0, 1])
@pytest.mark.parametrize("kind", ["hub_r4", "fem", "hub_r8+permuted"])
def test_walk_over_a_bucketized_pack(kind, precise):
    """A served ELL pack (ops/serve.py: ``m_base`` rounded up past ``m`` over
    all-zero pad rows, the virtual rows after them, pad virtual rows that
    fold 0 into the last target): every padded row is listed once, the walk
    gives the plain version's bits, and its real rows are the unbucketed
    pack's product."""
    _, _, port = _pack(kind)
    served = bucketize_pack(port)
    assert served.m_base > served.m and served.m_padded > port.m_padded
    t = ell_tiles(served)
    assert np.array_equal(t.rows, [p for rows in _logical_rows(served) for p in rows])
    b, _ = _operands(port, 12)
    c = torch.zeros((served.m_padded, 12))
    c[: port.m] = _operands(port, 12, seed=1)[1][: port.m]
    want = _ref(served, b, c, with_c=True, precise=precise)
    got = _walk(served, t, b, c, ALPHA, BETA, with_c=True, precise=precise)
    assert torch.equal(got, want)
    base = _ref(port, b, c[: port.m_padded].clone(), with_c=True, precise=precise)
    assert torch.equal(want[: port.m], base[: port.m])
    # as a plan uploads it: the run of pad virtual rows folded once
    n_fold = ell_fold_count(served)
    assert port.n_virt < n_fold < served.n_virt
    trimmed = dataclasses.replace(served, fold_rows=served.fold_rows[:n_fold])
    t = ell_tiles(trimmed)
    assert np.array_equal(t.rows, [p for rows in _logical_rows(trimmed) for p in rows])
    got = _walk(trimmed, t, b, c, ALPHA, BETA, with_c=True, precise=precise)
    assert torch.equal(got, want)
    assert torch.equal(_ref(trimmed, b, c, with_c=True, precise=precise), want)


@pytest.mark.parametrize("precise", [0, 1])
def test_walk_keeps_value0_slots_immune_to_a_nonfinite_b_row(precise):
    _, _, port = _pack("hub_r8")
    live0 = (port.cols == 0) & (port.vals != 0)
    port.vals = np.where(live0, np.float32(0), port.vals)  # column 0: value-0 slots only
    t = ell_tiles(port)
    b, c = _operands(port, 8, seed=3, nonfinite=0)
    want = _ref(port, b, c, with_c=True, precise=precise)
    got = _walk(port, t, b, c, ALPHA, BETA, with_c=True, precise=precise)
    assert torch.isfinite(want).all() and torch.equal(got, want)


@pytest.mark.parametrize("precise", [0, 1])
def test_walk_through_repeat_carries_the_virtual_rows(precise):
    _, _, port = _pack("hub_r4")
    port.config = port.config.with_(precise=precise)
    t = ell_tiles(port)
    b, c = _operands(port, 16, seed=4)
    c[port.m:] = 0.0  # SpmmPlan pads C with zeros past the real rows
    got = want = c
    for _ in range(3):
        want = _ref(port, b, want, with_c=True, precise=precise)
        got = _walk(port, t, b, got, ALPHA, BETA, with_c=True, precise=precise)
        assert torch.equal(got, want)
    m = port.m
    plan = tx.plan(port, 16, "ell_pallas", device="cpu")
    via = plan.repeat(b, ALPHA, BETA, c[:m], times=3)
    assert torch.equal(via, want[:m])


@pytest.mark.parametrize("kind,n", [("hub_r4", 16), ("hub_r8", 24), ("banded", 13),
                                    ("hub_r8+permuted", 16)])
def test_walk_agrees_with_the_jax_package(kind, n):
    coo, ref, port = _pack(kind)
    m = coo.shape[0]
    b, c = _operands(port, n, seed=1)
    got = _walk(port, ell_tiles(port), b, c, ALPHA, BETA, with_c=True, precise=0)[:m]
    b_np, c_np = b.numpy(), c[:m].numpy()
    exact = golden_spmm_exact(RefCSR.from_coo(coo), b_np, ALPHA, BETA, c_np)
    tol = 4 * np.spacing(np.float32(np.abs(exact).max()))
    if not kind.endswith("+permuted"):  # the JAX package folds in its own table's order
        for backend in ("ell_pallas_interpret", "ell"):
            want = np.asarray(RefPlan(ref, n, backend=backend)(b_np, ALPHA, BETA, c_np))
            assert np.abs(got.numpy() - want).max() <= tol
    assert tx.verify(exact, got.numpy()).passed
    assert np.abs(got.numpy() - exact).max() <= tol


def test_ell_launch_map_and_the_cpu_wrapper():
    # a lane group a tile, 16-byte chunks from N = 64, 256 threads a CTA
    go = ell_launch(512, 4, n_tiles=20834)
    assert (go.lanes, go.cols, go.threads, go.grid) == (32, 4, 256, (2605, 1))
    assert ell_launch(16, 1, n_tiles=4925)[:4] == (16, 1, 256, (308, 1))
    assert ell_launch(13, 1).lanes == 16 and ell_launch(1, 1).lanes == 1
    assert ell_launch(200, 4).lanes == 32 and ELL_VEC4_MIN_N == 16
    with pytest.raises(ValueError, match="n >= 1"):
        ell_launch(0, 4)
    # on the CPU the wrapper is the plain version, tiles or none
    _, _, port = _pack("hub_r8")
    b, c = _operands(port, 8)
    arrays = [torch.from_numpy(np.ascontiguousarray(a)) for a in
              (port.vals, port.cols, port.fold_rows)]
    before = launches(spmm_ell_gather_padded)
    got = spmm_ell_gather_padded(*arrays, b, c, ALPHA, BETA, m_base=port.m_base,
                                 ranges=ell_tiles(port))
    assert torch.equal(got, _ref(port, b, c, with_c=True, precise=0))
    assert launches(spmm_ell_gather_padded) == before


@pytest.mark.parametrize("width", [1, 2, 16, 64])
def test_rank_passes_add_rows_in_index_add_order(width):
    # add_rows_in_order's pass per rank on the card: each pass adds into a
    # row at most once, and the passes give index_add_'s sequential bits
    rng = np.random.default_rng(width)
    acc = torch.from_numpy((rng.standard_normal((50, width)) * 1e4).astype(np.float32))
    index = torch.from_numpy(rng.integers(0, 10, 400))
    src = torch.from_numpy(rng.standard_normal((400, width)).astype(np.float32))
    want = acc.clone().index_add_(0, index, src)
    groups = rank_groups(index)
    assert sum(g.numel() for g in groups) == 400
    for sel in groups:
        rows = index[sel]
        assert rows.unique().numel() == rows.numel() and torch.all(sel[1:] > sel[:-1])
        acc[rows] = acc[rows] + src[sel]
    assert torch.equal(acc, want)
