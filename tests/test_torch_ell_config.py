"""The ELL gather engine as the benchmark's ``cant_ell_n512`` runs it, on
the CPU at a small size: ``pack_ell`` with R left to its chooser, then
``SpmmPlan(..., "ell_pallas" | "ell", device="cpu")``.

* The plan against the benchmark's plain f64 reference
  (``bench_torch/reference.py``), with and without C, on a FEM matrix whose
  rows outgrow R, so that virtual rows are folded.
* The six ``ell.*`` counters: each equal to what the pack gives when
  counted again here (the tiles by a plain loop over the logical rows), and
  each counted once however many plans share the pack.
* The benchmark's four readers of this cell (``bench_torch/metrics/``) on
  made-up records, and where what they read is absent.
"""

from __future__ import annotations

import torch_cpu  # noqa: F401  one torch thread per xdist worker

import numpy as np
import pytest
import torch

import sextans_tpu_torch as tx
from bench_torch import harness, reference
from bench_torch.roofline import spmm_bound_s
from bench_torch.trace import Op, Trace
from sextans_tpu_torch.ops.spmm_ell import ELL_GROUP_MAX, ELL_LONG_ROWS, ell_tiles
from sextans_tpu_torch.utils import profiling
from sextans_tpu_torch.utils.matrices import fem_like

N = 40
ALPHA, BETA = 0.85, -2.06
CFG = tx.SpmmConfig(tile_m=128)  # R unset: pack_ell's chooser picks it
MAX_ULP = 4.0  # of max|C|: f32 FFMA chains over ~60 terms, against f64
UPLOAD_COUNTERS = ("ell.entries", "ell.slots", "ell.rows", "ell.fold_rows")
TILE_COUNTERS = ("ell.tiles", "ell.tile_rows")


@pytest.fixture(scope="module")
def coo():
    # 3 x 3 node blocks, 21-66 entries a row: more than R on most rows
    return fem_like(600, dofs=3, neighbors=22, bandwidth=100, seed=13)


def packed_of(coo):
    return tx.pack_ell(coo, CFG)


@pytest.fixture(scope="module")
def packed(coo):
    return packed_of(coo)


def test_rows_outgrow_r_so_virtual_rows_are_folded(coo, packed):
    deg = np.bincount(coo.rows, minlength=coo.shape[0])
    assert packed.config.ell_r is None
    assert packed.n_virt > 0 and deg.max() > packed.slots_per_row


def operands(coo, seed=0):
    g = torch.Generator().manual_seed(seed)
    m, k = coo.shape
    return torch.randn(k, N, generator=g), torch.randn(m, N, generator=g)


@pytest.mark.parametrize("with_c", [True, False])
@pytest.mark.parametrize("backend", ["ell_pallas", "ell"])
def test_plan_against_the_benchmark_reference(coo, packed, backend, with_c):
    b, c = operands(coo)
    plan = tx.SpmmPlan(packed, N, backend, device="cpu")
    out = plan(b, ALPHA, BETA, c) if with_c else plan(b, ALPHA)
    a = reference.Coo(coo.shape, torch.as_tensor(coo.rows.astype(np.int64)),
                      torch.as_tensor(coo.cols.astype(np.int64)))
    vals = torch.as_tensor(coo.vals)
    ref = (reference.spmm(a, vals, b, c, ALPHA, BETA) if with_c
           else reference.spmm(a, vals, b, torch.zeros_like(c), ALPHA, 0.0))
    assert reference.ulp_gap(out, ref) <= MAX_ULP


def tiles_by_hand(packed):
    """K5's tiles counted by a plain loop: (tiles, logical rows summed over
    the tiles). A logical row is a real row and its virtual rows, or a pad
    row; a tile takes up to ELL_GROUP_MAX consecutive logical rows whose
    padded rows hold the same columns, or one logical row each where that
    leaves fewer than two a tile; a logical row of more than ELL_LONG_ROWS
    padded rows is a tile of one row for each of its padded rows."""
    m, n_virt, m_padded = packed.m_base, packed.n_virt, packed.m_padded
    virt = {i: [] for i in range(m)}
    for j, target in enumerate(packed.fold_rows):
        virt[int(target)].append(m + j)
    logical = [[i] + virt[i] for i in range(m)]
    logical += [[p] for p in range(m + n_virt, m_padded)]
    groups = []  # [columns of the rows, members, tiles]
    for rows in logical:
        if len(rows) > ELL_LONG_ROWS:
            groups.append([None, 1, len(rows)])
            continue
        key = tuple(tuple(packed.cols[p]) for p in rows)
        if groups and groups[-1][0] == key and groups[-1][1] < ELL_GROUP_MAX:
            groups[-1][1] += 1
        else:
            groups.append([key, 1, 1])
    short = [g for g in groups if g[0] is not None]
    if sum(g[1] for g in short) < 2 * len(short):
        groups = [[None, 1, len(r) if len(r) > ELL_LONG_ROWS else 1] for r in logical]
    return sum(g[2] for g in groups), sum(g[1] * g[2] for g in groups)


def expected(coo, packed, name):
    """Counter ``name`` for one pack, from the COO and the pack's shape."""
    deg = np.bincount(coo.rows, minlength=coo.shape[0])
    r = packed.slots_per_row
    virtual = int(np.maximum(-(-deg // r) - 1, 0).sum())
    m_padded = -(-(coo.shape[0] + virtual) // CFG.tile_m) * CFG.tile_m
    tiles, tile_rows = tiles_by_hand(packed)
    return {"ell.entries": coo.nnz, "ell.slots": m_padded * r, "ell.rows": m_padded,
            "ell.fold_rows": virtual, "ell.tiles": tiles, "ell.tile_rows": tile_rows}[name]


def delta(before, after, name):
    return after.get(name, 0) - before.get(name, 0)


@pytest.fixture(scope="module")
def two_plans(coo):
    """The counters' change over two plans of each CPU backend on one new
    pack, then its tiles made once (on a card the first plan makes them;
    on the CPU no plan does)."""
    packed = packed_of(coo)
    before = tx.counters()
    for backend in ("ell_pallas", "ell", "ell_pallas"):
        tx.SpmmPlan(packed, N, backend, device="cpu")
    planned = tx.counters()
    ell_tiles(packed)
    return packed, before, planned, tx.counters()


@pytest.mark.parametrize("name", UPLOAD_COUNTERS)
def test_upload_counter_is_counted_once_a_pack(coo, two_plans, name):
    packed, before, planned, _ = two_plans
    assert delta(before, planned, name) == expected(coo, packed, name)


@pytest.mark.parametrize("name", TILE_COUNTERS)
def test_tile_counter_is_counted_where_the_tiles_are_made(coo, two_plans, name):
    packed, before, planned, after = two_plans
    assert delta(before, planned, name) == 0  # the CPU's plans walk no tiles
    assert delta(planned, after, name) == expected(coo, packed, name)


def test_virtual_row_counters_are_nonzero_here(coo, two_plans):
    packed, before, planned, after = two_plans
    assert delta(before, planned, "ell.fold_rows") == packed.n_virt > 0
    assert delta(planned, after, "ell.tile_rows") > delta(planned, after, "ell.tiles")


# ---- the benchmark's readers of this cell ----

def record(trace=None, shape=None):
    return harness.Record(0.0, 1.0, 2, shape or {}, trace)


COUNTER_READERS = {  # metric -> (numerator, denominator, scale)
    "ell_fill_pct": ("ell.entries", "ell.slots", 100.0),
    "ell_fold_pct": ("ell.fold_rows", "ell.rows", 100.0),
    "ell_tile_rows": ("ell.tile_rows", "ell.tiles", 1.0),
}


@pytest.mark.parametrize("metric", sorted(COUNTER_READERS))
def test_counter_reader_reads_its_ratio(metric, monkeypatch):
    num, den, scale = COUNTER_READERS[metric]
    monkeypatch.setattr(profiling, "_COUNTERS", {num: 4007385, den: 4497408})
    got = harness.load_reader(metric).read(record())
    assert got == pytest.approx(scale * 4007385 / 4497408)


@pytest.mark.parametrize("missing", ["numerator", "denominator", "both", "zero"])
@pytest.mark.parametrize("metric", sorted(COUNTER_READERS))
def test_counter_reader_reads_none_without_its_counters(metric, missing, monkeypatch):
    num, den, _ = COUNTER_READERS[metric]
    held = {"numerator": {den: 9}, "denominator": {num: 9}, "both": {},
            "zero": {num: 0, den: 0}}[missing]
    monkeypatch.setattr(profiling, "_COUNTERS", held)
    assert harness.load_reader(metric).read(record()) is None


def test_counter_readers_on_a_cpu_plan(coo, monkeypatch):
    """After a fresh pack's plan on the CPU the pack's readers read it; the
    tiles' reader reads once the tiles are made."""
    monkeypatch.setattr(profiling, "_COUNTERS", {})
    packed = packed_of(coo)
    tx.SpmmPlan(packed, N, "ell_pallas", device="cpu")
    read = lambda metric: harness.load_reader(metric).read(record())  # noqa: E731
    assert read("ell_fill_pct") == pytest.approx(100.0 * coo.nnz / packed.vals.size)
    assert read("ell_fold_pct") == pytest.approx(100.0 * packed.n_virt / packed.m_padded)
    assert read("ell_tile_rows") is None
    ell_tiles(packed)
    tiles, tile_rows = tiles_by_hand(packed)
    assert read("ell_tile_rows") == pytest.approx(tile_rows / tiles)


US = 1e-6
SHAPE = {"m": 62451, "k": 62451, "n": 512, "nnz": 4007385}


def trace_of(*ops, units=2):
    device = [Op(name, "kernel", t0 * US, t1 * US) for name, t0, t1 in ops]
    return Trace(device, [], [], 0.0, 2000 * US, units)


def test_roofline_reader_counts_k5_and_its_fold_only():
    tr = trace_of(("void spmm_ell_kernel<3, 8, false>(float const*, int const*)", 0, 400),
                  ("void spmm_ell_long_fold_kernel(int const*, int const*)", 400, 450),
                  ("void spmm_slab_tc_kernel<2, 1>(float const*)", 450, 900),
                  ("Memcpy DtoD (Device -> Device)", 900, 1000),
                  ("void spmm_ell_kernel<3, 8, false>(float const*, int const*)", 1000, 1400))
    got = harness.load_reader("spmm_ell_roofline").read(record(tr, SHAPE))
    bound = spmm_bound_s(SHAPE["nnz"], SHAPE["m"], SHAPE["k"], SHAPE["n"])
    assert got == pytest.approx(100.0 * bound / (850 * US / 2))


@pytest.mark.parametrize("trace", [
    None,
    trace_of(("void spmm_slab_tc_kernel<2, 1>(float const*)", 0, 400)),
    trace_of(),
    trace_of(("void spmm_ell_kernel<3, 8, false>(float const*)", 0, 400), units=0),
], ids=["untraced", "no_ell_kernel", "no_device_work", "no_units"])
def test_roofline_reader_reads_none_without_k5(trace):
    assert harness.load_reader("spmm_ell_roofline").read(record(trace, SHAPE)) is None
