"""The hybrid structure split as the benchmark's ``scircuit_hybrid_n512``
runs it, on the CPU at a small size: the circuit stand-in
(``circuit_like`` with the cell's keys, at a few thousand rows) through
``split_structure(coo, n=N)`` and ``HybridSpmmPlan(..., device="cpu")``
with the cell's residue route (``mxu``, the mxu cells' slab config).

* The product against the benchmark's plain f64 reference
  (``bench_torch/reference.py``), with and without C, over all rows and over
  the rows outside the hubs; the same product in TF32 reads above the bar.
* A matrix whose split has all four parts, the residue through K1's route.
* The ``hybrid.*`` counters: each equal to a plain count of the split's
  arrays, counted once a split however many plans share it, and
  ``hybrid.calls`` once a step.
* The spans ``sx.hybrid.call`` and ``sx.hybrid.dense`` under a profiler.
* The benchmark's five readers of this cell on made-up records, and where
  what they read is absent.
* The loop's ``max_ulp_rest`` on a fault confined to the rows outside the
  hubs, which ``max_ulp`` does not see.

On the ``"pallas"`` DIA route the plain step adds the hub parts by one
row-sparse pass (``ops/hybrid_hub.py``) in place of the dense planes: that
step against the f64 reference and the ``"xla"`` step, on splits with and
without diagonals, hub rows and a residue; the caller's C untouched; the
plain pass against a walk of the planes by hand; the pass once a step and
its counters once a plan; the ``"xla"`` steps on their planes; the
precise ``"pallas"`` step by one pass a part, no less accurate than plain
mode.

The card tests (marked ``gpu``, skipped without a CUDA device) run the
cell's stand-in at its full size: the plan, the hub kernel against its plain
version to the bit, a step's device operations under a profiler, and the
precise step against plain mode.
"""

from __future__ import annotations

import torch_cpu  # noqa: F401  one torch thread per xdist worker

import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import sextans_tpu_torch as tx
from bench_torch import harness, reference
from bench_torch.loops import hybrid_repeat
from bench_torch.roofline import spmm_bound_s
from bench_torch.trace import Op, Trace
from sextans_tpu_torch.ops import hybrid as hybrid_mod
from sextans_tpu_torch.ops.hybrid_hub import HUB_PARTS, hub_lists, hybrid_hub, hybrid_hub_ref
from sextans_tpu_torch.ops.launch import f32, fma_f32
from sextans_tpu_torch.ops.spmm_dia import spmm_dia
from sextans_tpu_torch.utils import profiling
from sextans_tpu_torch.utils.matrices import circuit_like

N = 40
ALPHA, BETA = 0.85, -2.06
CELL = harness.load_json(harness.ROOT / "bench_torch/configs/scircuit_hybrid_n512.json")
CFG = tx.SpmmConfig(**CELL["spmm_config"])
LIMITS = harness.load_json(harness.ROOT / "bench_torch/limits/scircuit_hybrid_n512.repeat.json")
# The plain hybrid sums each part in f32 (a diagonal at a time; the hub
# parts by the row-sparse pass on the "pallas" route, by matmuls in MKL's
# order on the "xla" one, cuBLAS's on a card) and adds the parts in
# turn: a few roundings of the largest element, so 4 ulp of max|C|, the
# plain hybrid's bar on the card. Readings here (seed 0): 0.73 with C, 1.73
# without; the rows outside the hubs 1.44. TF32 reads 2,900 and more.
MAX_ULP = 4.0
# At full size a hub row sums ~850 terms in f32, on the card in the hub
# pass's 8 strided partial sums and their tree (until it, cuBLAS's split-K
# order: 4.0-5.4 ulp of max|C| over all rows, H100, eight seeds; 1.3-1.8
# outside the hubs, where MAX_ULP holds).
FULL_MAX_ULP = 8.0
COUNTERS = ("hybrid.diag_entries", "hybrid.diag_slots", "hybrid.dense_entries",
            "hybrid.dense_slots", "hybrid.residue_entries")


def stand_in(m=3000):
    """The cell's stand-in at ``m`` rows, with its other keys."""
    return circuit_like(m, **{k: v for k, v in CELL["matrix"]["args"].items() if k != "m"})


def with_scatter(m=3000, extra=1000):
    """The stand-in with ``extra`` scattered entries, which the split leaves
    in the residue: every part of the split holds entries."""
    base = stand_in(m)
    rng = np.random.default_rng(4)
    lin, keep = np.unique(
        np.concatenate([base.rows, rng.integers(0, m, extra)]).astype(np.int64) * m
        + np.concatenate([base.cols, rng.integers(0, m, extra)]), return_index=True)
    vals = np.concatenate([base.vals, rng.standard_normal(extra).astype(np.float32)])[keep]
    return tx.COOMatrix((m, m), (lin // m).astype(np.int32), (lin % m).astype(np.int32), vals)


def plan_of(split, n=N, device="cpu"):
    """The cell's plan over ``split``."""
    return tx.HybridSpmmPlan(split, n, residue_fmt=CELL["format"], residue_config=CFG,
                             backend=CELL["backend"], dia_backend=CELL["dia_backend"],
                             precise=CELL["precise"], device=device)


def a_of(coo, device="cpu"):
    return (reference.Coo(coo.shape, torch.as_tensor(coo.rows.astype(np.int64), device=device),
                          torch.as_tensor(coo.cols.astype(np.int64), device=device)),
            torch.as_tensor(coo.vals, device=device))


def operands(m, n=N, seed=0, device="cpu"):
    g = torch.Generator(device=device).manual_seed(seed)
    return (torch.randn(m, n, generator=g, device=device),
            torch.randn(m, n, generator=g, device=device))


def rest_rows(split, device="cpu"):
    rest = torch.ones(split.m, dtype=torch.bool, device=device)
    rest[torch.as_tensor(split.head_rows.astype(np.int64), device=device)] = False
    return rest


@pytest.fixture(scope="module")
def coo():
    return stand_in()


@pytest.fixture(scope="module")
def split(coo):
    return tx.split_structure(coo, n=N)


def test_the_cell_routes_its_residue_through_k1():
    assert (CELL["format"], CELL["backend"], CELL["dia_backend"]) == ("mxu", "mxu", "auto")
    assert CELL["precise"] == 0 and CELL["split"] == {} and CELL["n"] == 512
    assert CELL["spmm_config"] == {"tile_m": 1024, "window_k": 4096, "block_k": 128,
                                   "group_blocks": 8, "chunk_unroll": 2}


def test_the_stand_in_splits_into_diagonals_and_hubs(split):
    # as at full size: the band's 121 diagonals, 71 hub columns and rows
    # (give or take the hubs that share a column with the band), no residue
    assert split.diag_offsets.size == 121
    assert np.array_equal(split.diag_offsets, np.arange(-60, 61))
    assert split.head_cols.size == split.head_rows.size == 71
    assert split.residue.nnz == 0


@pytest.mark.parametrize("with_c", [True, False])
def test_the_cells_route_against_the_f64_reference(coo, split, with_c):
    b, c = operands(coo.shape[0])
    plan = plan_of(split)
    assert plan.dia_backend == "xla" and plan.residue_plan is None
    a, vals = a_of(coo)
    if with_c:
        out, ref = plan(b, ALPHA, BETA, c), reference.spmm(a, vals, b, c, ALPHA, BETA)
        lower = reference.spmm(a, vals, b, c, ALPHA, BETA, "tf32")
    else:
        zero = torch.zeros_like(c)
        out, ref = plan(b, ALPHA), reference.spmm(a, vals, b, zero, ALPHA, 0.0)
        lower = reference.spmm(a, vals, b, zero, ALPHA, 0.0, "tf32")
    rest = rest_rows(split)
    assert reference.ulp_gap(out, ref) <= MAX_ULP
    assert reference.ulp_gap(out[rest], ref[rest]) <= MAX_ULP
    assert reference.ulp_gap(lower, ref) > 100 * MAX_ULP


@pytest.fixture(scope="module")
def four_parts():
    coo = with_scatter()
    split = tx.split_structure(coo, n=N)
    assert split.diag_offsets.size and split.head_cols.size and split.head_rows.size
    assert split.residue.nnz
    return coo, split


@pytest.mark.parametrize("with_c", [True, False])
def test_a_split_with_all_four_parts_against_the_f64_reference(four_parts, with_c):
    coo, split = four_parts
    plan = plan_of(split)
    assert plan.residue_plan.backend == "mxu"
    assert isinstance(plan.residue_plan.packed, tx.PackedSpMatrixMXU)
    b, c = operands(coo.shape[0], seed=1)
    a, vals = a_of(coo)
    if with_c:
        out, ref = plan(b, ALPHA, BETA, c), reference.spmm(a, vals, b, c, ALPHA, BETA)
    else:
        out, ref = plan(b, ALPHA), reference.spmm(a, vals, b, torch.zeros_like(c), ALPHA, 0.0)
    assert reference.ulp_gap(out, ref) <= MAX_ULP


def by_hand(split):
    """The five counters by plain loops over the split's arrays."""
    diag = sum(1 for row in split.diag_vals for v in row if v != 0)
    dense = (sum(1 for row in split.head_dense for v in row if v != 0)
             + sum(1 for row in split.head_rows_dense for v in row if v != 0))
    return {"hybrid.diag_entries": diag,
            "hybrid.diag_slots": split.diag_offsets.size * split.m,
            "hybrid.dense_entries": dense,
            "hybrid.dense_slots": split.m * split.head_cols.size + split.head_rows.size * split.k,
            "hybrid.residue_entries": len(split.residue.rows)}


def delta(before, after, name):
    return after.get(name, 0) - before.get(name, 0)


@pytest.fixture(scope="module")
def three_plans():
    """The counters' change over three plans on one new split with every
    part."""
    split = tx.split_structure(with_scatter(), n=N)
    before = tx.counters()
    for _ in range(3):
        plan_of(split)
    return by_hand(split), before, tx.counters()


@pytest.mark.parametrize("name", COUNTERS)
def test_counter_is_counted_once_a_split(three_plans, name):
    want, before, after = three_plans
    assert want[name] > 0 and delta(before, after, name) == want[name]


def test_split_and_plan_add_set_up_seconds(coo):
    before = tx.counters()
    split = tx.split_structure(coo, n=N)
    mid = tx.counters()
    plan_of(split)
    after = tx.counters()
    assert mid["pack_s"] > before.get("pack_s", 0.0)
    assert mid.get("upload_s", 0.0) == before.get("upload_s", 0.0)
    assert after["upload_s"] > mid.get("upload_s", 0.0)


def test_calls_are_counted_once_a_step(coo, split):
    plan = plan_of(split)
    b, c = operands(coo.shape[0])
    before = tx.counters().get("hybrid.calls", 0)
    plan(b, ALPHA, BETA, c)
    plan(b, ALPHA)
    plan.repeat(b, ALPHA, BETA, c, times=3)
    assert tx.counters()["hybrid.calls"] - before == 5


def spans(prof):
    """The profiler's ranges named ``sx.*``: name -> [(start, end)]."""
    out = {}
    for e in prof.events():
        if e.name.startswith("sx."):
            out.setdefault(e.name, []).append((e.time_range.start, e.time_range.end))
    return out


def test_steps_record_their_spans(four_parts):
    coo, split = four_parts
    plan = plan_of(split)
    b, c = operands(coo.shape[0])
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        plan(b, ALPHA, BETA, c)
        plan.repeat(b, ALPHA, BETA, c, times=2)
    got = spans(prof)
    calls, dense = got["sx.hybrid.call"], got["sx.hybrid.dense"]
    assert len(calls) == len(dense) == 3
    # each step's dense parts and residue plan inside its own call
    for inner in ("sx.hybrid.dense", "sx.plan.call"):
        assert len(got[inner]) == 3
        for a0, a1 in got[inner]:
            assert any(c0 <= a0 and a1 <= c1 for c0, c1 in calls)


def test_spans_change_no_bit(four_parts):
    coo, split = four_parts
    plan = plan_of(split)
    b, c = operands(coo.shape[0])
    plain = plan(b, ALPHA, BETA, c)
    with profile(activities=[ProfilerActivity.CPU]):
        traced = plan(b, ALPHA, BETA, c)
    assert torch.equal(plain, traced)


# ---- the plain "pallas" step: the hub parts as one row-sparse pass ----

def moved(split, part):
    """``split`` with its diagonals (``"diagonals"``) or hub rows
    (``"rows"``) moved into the residue: the same matrix, a split without
    that part."""
    res = split.residue
    if part == "diagonals":
        d, r = np.nonzero(split.diag_vals)
        rows, cols = r, r + split.diag_offsets[d]
        vals = split.diag_vals[d, r]
        split = dataclasses.replace(split, diag_offsets=split.diag_offsets[:0],
                                    diag_vals=split.diag_vals[:0])
    else:
        rank, cols = np.nonzero(split.head_rows_dense)
        rows, vals = split.head_rows[rank], split.head_rows_dense[rank, cols]
        split = dataclasses.replace(split, head_rows=split.head_rows[:0],
                                    head_rows_dense=split.head_rows_dense[:0])
    residue = tx.COOMatrix((split.m, split.k),
                           np.concatenate([res.rows, rows]).astype(np.int32),
                           np.concatenate([res.cols, cols]).astype(np.int32),
                           np.concatenate([res.vals, vals]).astype(np.float32))
    return dataclasses.replace(split, residue=residue)


@pytest.fixture(scope="module")
def shapes(coo, split, four_parts):
    """The stand-in's split, a split with all four parts, one without
    diagonals and one with head columns but no hub rows (both of the
    stand-in, the moved part in the residue, through K1's route)."""
    return {"stand_in": (coo, split), "four_parts": four_parts,
            "no_diagonals": (coo, moved(split, "diagonals")),
            "no_hub_rows": (coo, moved(split, "rows"))}


def pallas_plan(split, n=N, device="cpu", **kw):
    return tx.HybridSpmmPlan(split, n, residue_fmt=CELL["format"], residue_config=CFG,
                             backend=CELL["backend"], dia_backend="pallas",
                             precise=kw.pop("precise", CELL["precise"]), device=device, **kw)


@pytest.mark.parametrize("with_c", [True, False])
@pytest.mark.parametrize("shape", ["stand_in", "four_parts", "no_diagonals", "no_hub_rows"])
def test_the_pallas_step_against_the_f64_reference_and_the_xla_step(shapes, shape, with_c):
    coo, split = shapes[shape]
    if shape == "no_diagonals":
        assert not split.diag_offsets.size and split.head_rows.size
    if shape == "no_hub_rows":
        assert split.diag_offsets.size and split.head_cols.size and not split.head_rows.size
    plan = pallas_plan(split)
    assert plan._hub is not None and plan._head is plan._hrows is None
    assert (plan.residue_plan is None) == (shape == "stand_in")
    b, c = operands(coo.shape[0], seed=2)
    a, vals = a_of(coo)
    kept = c.clone()
    if with_c:
        out, ref = plan(b, ALPHA, BETA, c), reference.spmm(a, vals, b, c, ALPHA, BETA)
        xla = plan_of(split)(b, ALPHA, BETA, c)
    else:
        out, ref = plan(b, ALPHA), reference.spmm(a, vals, b, torch.zeros_like(c), ALPHA, 0.0)
        xla = plan_of(split)(b, ALPHA)
    assert torch.equal(c, kept)  # the caller's C is never written
    rest = rest_rows(split)
    assert reference.ulp_gap(out, ref) <= MAX_ULP
    assert reference.ulp_gap(out[rest], ref[rest]) <= MAX_ULP
    assert reference.ulp_gap(out, xla) <= MAX_ULP


@pytest.mark.parametrize("shape", ["stand_in", "no_diagonals"])
def test_the_pallas_step_leaves_the_callers_c_over_repeats(shapes, shape):
    coo, split = shapes[shape]
    plan = pallas_plan(split)
    b, c = operands(coo.shape[0], seed=5)
    kept = c.clone()
    chained = plan.repeat(b, ALPHA, BETA, c, times=2)
    assert torch.equal(c, kept)
    assert torch.equal(chained, plan(b, ALPHA, BETA, plan(b, ALPHA, BETA, c)))
    assert torch.equal(c, kept)


def by_hand_pass(split, out, b, alpha):
    """The hub pass walked by hand from the split's planes, a row at a time:
    its head entries by ascending column id, then its hub row as
    ``HUB_PARTS`` strided partial sums added in the kernel's tree."""
    out = out.clone()
    a = torch.full((1,), f32(alpha))
    rank = {int(r): i for i, r in enumerate(split.head_rows)}
    for i in sorted(set(np.flatnonzero(split.head_dense.any(axis=1))) | set(rank)):
        ks = np.flatnonzero(split.head_dense[i])
        head = sorted(zip(split.head_cols[ks].tolist(), split.head_dense[i, ks].tolist()))
        hub = []
        if i in rank:
            cs = np.flatnonzero(split.head_rows_dense[rank[i]])
            hub = list(zip(cs.tolist(), split.head_rows_dense[rank[i], cs].tolist()))
        o = out[i]
        if head:
            s = torch.zeros_like(o)
            for col, v in head:
                s = fma_f32(torch.tensor([v]), b[col], s)
            o = fma_f32(a, s, o)
        if hub:
            parts = []
            for w in range(HUB_PARTS):
                s = torch.zeros_like(o)
                for col, v in hub[w::HUB_PARTS]:
                    s = fma_f32(torch.tensor([v]), b[col], s)
                parts.append(s)
            while len(parts) > 1:
                h = len(parts) // 2
                parts = [parts[w] + parts[w + h] for w in range(h)]
            o = fma_f32(a, parts[0], o)
        out[i] = o
    return out


@pytest.mark.parametrize("m,n", [(600, 40), (900, 7)])
def test_the_plain_pass_walks_the_planes_in_the_kernels_order(m, n):
    split = tx.split_structure(stand_in(m), n=n, min_head_cols=1, min_head_rows=1)
    assert split.head_cols.size and split.head_rows.size
    lists = hub_lists(split.head_cols, split.head_dense, split.head_rows,
                      split.head_rows_dense, "cpu")
    assert lists.entries == split.head_nnz + split.head_row_nnz
    assert lists.jobs == len(set(np.flatnonzero(split.head_dense.any(axis=1)))
                             | set(split.head_rows.tolist()))
    b, out = operands(m, n, seed=6)
    want = by_hand_pass(split, out, b, ALPHA)
    got = out.clone()
    assert hybrid_hub(got, b, ALPHA, lists) is got
    assert torch.equal(got, want)


def test_the_pallas_step_runs_the_pass_once_a_step(monkeypatch, four_parts):
    coo, split = four_parts
    before = tx.counters()
    plans = [pallas_plan(split) for _ in range(2)]
    after = tx.counters()
    lists = plans[0]._hub
    assert delta(before, after, "hybrid.hub_entries") == 2 * lists.entries
    assert lists.entries == split.head_nnz + split.head_row_nnz > 0
    assert delta(before, after, "hybrid.hub_rows") == 2 * lists.jobs > 0
    ran = []
    monkeypatch.setattr(hybrid_mod, "hybrid_hub", lambda *a: ran.append(a[0]) or a[0])
    b, c = operands(coo.shape[0])
    plans[0](b, ALPHA, BETA, c)
    plans[0](b, ALPHA)
    plans[0].repeat(b, ALPHA, BETA, c, times=3)
    assert len(ran) == 5


@pytest.mark.parametrize("precise", [0, 2])
def test_the_xla_steps_keep_their_planes(monkeypatch, four_parts, precise):
    coo, split = four_parts
    before = tx.counters()
    plan = tx.HybridSpmmPlan(split, N, residue_fmt=CELL["format"], residue_config=CFG,
                             backend=CELL["backend"], dia_backend="xla", precise=precise,
                             device="cpu")
    assert delta(before, tx.counters(), "hybrid.hub_entries") == 0
    assert plan.hub_passes == ()
    assert plan._head.shape == split.head_dense.shape
    assert plan._hrows.shape == split.head_rows_dense.shape
    monkeypatch.setattr(hybrid_mod, "hybrid_hub", lambda *a: pytest.fail("the pass ran"))
    b, c = operands(coo.shape[0], seed=7)
    a, vals = a_of(coo)
    out, ref = plan(b, ALPHA, BETA, c), reference.spmm(a, vals, b, c, ALPHA, BETA)
    assert reference.ulp_gap(out, ref) <= MAX_ULP


@pytest.mark.parametrize("precise", [1, 2])
def test_the_precise_pallas_step_passes_each_part_on_its_own(monkeypatch, four_parts,
                                                             precise):
    """The precise step on the ``"pallas"`` route: the head columns and the
    hub rows each by a compensated pass of their own at alpha = 1 into
    zeros, no plane uploaded; its counters the planes' nonzeros; the step
    no less accurate than plain mode."""
    coo, split = four_parts
    before = tx.counters()
    plan = pallas_plan(split, precise=precise)
    after = tx.counters()
    head, rows = plan._head_hub, plan._row_hub
    assert plan._hub is plan._head is plan._hrows is None
    assert plan.hub_passes == (head, rows)
    assert (head.m, head.n_hub, head.entries) == (split.m, 0, split.head_nnz)
    assert head.jobs == int(split.head_dense.any(axis=1).sum())
    assert (rows.m, rows.n_hub, rows.jobs) == ((split.head_rows.size,) * 3)
    assert rows.entries == split.head_row_nnz
    assert delta(before, after, "hybrid.hub_entries") == split.head_nnz + split.head_row_nnz
    assert delta(before, after, "hybrid.hub_rows") == head.jobs + rows.jobs
    b, c = operands(coo.shape[0], seed=9)
    # a part alone is the pass over its entries, from zeros at alpha = 1
    got_head, got_rows = plan._hub_parts(b)
    assert torch.equal(got_head, hybrid_hub_ref(torch.zeros(split.m, N), b, 1.0, head, 1))
    plain = pallas_plan(split)
    hub_only = hybrid_hub(torch.zeros(split.m, N), b, 1.0, hub_lists(
        split.head_cols[:0], split.head_dense[:, :0], split.head_rows, split.head_rows_dense,
        "cpu"), precise)
    assert torch.equal(got_rows, hub_only[torch.as_tensor(split.head_rows.astype(np.int64))])
    a, vals = a_of(coo)
    ref = reference.spmm(a, vals, b, c, ALPHA, BETA)
    out, plain_out = plan(b, ALPHA, BETA, c), plain(b, ALPHA, BETA, c)
    assert reference.ulp_gap(out, ref) <= reference.ulp_gap(plain_out, ref) <= MAX_ULP
    ran = []
    real = hybrid_mod.hybrid_hub
    monkeypatch.setattr(hybrid_mod, "hybrid_hub", lambda *a: ran.append(a[3]) or real(*a))
    assert torch.equal(plan(b, ALPHA, BETA, c), out)
    plan.repeat(b, ALPHA, BETA, c, times=2)
    assert ran == [head, rows] * 3


@pytest.mark.parametrize("m,n", [(600, 40), (900, 7)])
def test_the_precise_pass_rounds_each_part_once(m, n):
    """At precise 1 the pass sums each row's head part and hub part as
    compensated pairs and adds each rounded once: into zeros at alpha = 1
    a part is within half an ulp (and a hair) of its exact value, where the
    plain pass's sums are not."""
    split = tx.split_structure(stand_in(m), n=n, min_head_cols=1, min_head_rows=1)
    assert split.head_cols.size and split.head_rows.size
    none = np.zeros(0, dtype=np.int64)
    b, _ = operands(m, n, seed=10)
    b64 = b.double().numpy()
    hub_exact = np.zeros((m, n))
    hub_exact[split.head_rows] = split.head_rows_dense.astype(np.float64) @ b64
    parts = {"head": (hub_lists(split.head_cols, split.head_dense, none,
                                np.zeros((0, m), np.float32), "cpu"),
                      split.head_dense.astype(np.float64) @ b64[split.head_cols]),
             "hub": (hub_lists(none, np.zeros((m, 0), np.float32), split.head_rows,
                               split.head_rows_dense, "cpu"), hub_exact)}
    errs = {}
    for name, (lists, exact) in parts.items():
        spacing = np.spacing(np.abs(exact).astype(np.float32)).astype(np.float64)
        for precise in (0, 1):
            got = hybrid_hub_ref(torch.zeros(m, n), b, 1.0, lists, precise).double().numpy()
            errs[name, precise] = (np.abs(got - exact) / spacing).max()
    for name in ("head", "hub"):
        assert errs[name, 1] <= 0.5 + 1e-6
        assert errs[name, 0] > errs[name, 1]


# ---- the benchmark's readers of this cell ----

def record(trace=None, shape=None):
    return harness.Record(0.0, 1.0, 2, shape or {}, trace)


COUNTER_READERS = {  # metric -> (numerator, denominator)
    "dia_fill_pct": ("hybrid.diag_entries", "hybrid.diag_slots"),
    "hub_fill_pct": ("hybrid.dense_entries", "hybrid.dense_slots"),
}


@pytest.mark.parametrize("metric", sorted(COUNTER_READERS))
def test_counter_reader_reads_its_share(metric, monkeypatch):
    num, den = COUNTER_READERS[metric]
    monkeypatch.setattr(profiling, "_COUNTERS", {num: 838244, den: 20690758})
    got = harness.load_reader(metric).read(record())
    assert got == pytest.approx(100.0 * 838244 / 20690758)


@pytest.mark.parametrize("missing", ["numerator", "denominator", "both", "zero"])
@pytest.mark.parametrize("metric", sorted(COUNTER_READERS))
def test_counter_reader_reads_none_without_its_counters(metric, missing, monkeypatch):
    num, den = COUNTER_READERS[metric]
    held = {"numerator": {den: 9}, "denominator": {num: 9}, "both": {},
            "zero": {num: 0, den: 0}}[missing]
    monkeypatch.setattr(profiling, "_COUNTERS", held)
    assert harness.load_reader(metric).read(record()) is None


def test_counter_readers_on_a_cpu_plan(monkeypatch):
    """After a fresh split's plan on the CPU both readers read it."""
    monkeypatch.setattr(profiling, "_COUNTERS", {})
    split = tx.split_structure(with_scatter(), n=N)
    plan_of(split)
    want = by_hand(split)
    read = lambda metric: harness.load_reader(metric).read(record())  # noqa: E731
    assert read("dia_fill_pct") == pytest.approx(
        100.0 * want["hybrid.diag_entries"] / want["hybrid.diag_slots"])
    assert read("hub_fill_pct") == pytest.approx(
        100.0 * want["hybrid.dense_entries"] / want["hybrid.dense_slots"])


US = 1e-6
SHAPE = {"m": 170998, "k": 170998, "n": 512, "nnz": 959038}
K6 = "void spmm_dia_kernel<false, 0>(float const*, int const*, float const*)"
GEMM = "sm90_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize128x128x32_warpgroupsize1x1x1"
ADD = "void at::native::vectorized_elementwise_kernel<4, at::native::AddFunctor<float>>(int)"
K1 = "void spmm_slab_tc_kernel<2, 4>(float const*, int const*)"


def trace_of(*ops, units=2):
    device = [Op(name, "kernel", t0 * US, t1 * US) for name, t0, t1 in ops]
    return Trace(device, [], [], 0.0, 6000 * US, units)


# two products: K6 overlaps a GEMM by 100 us in the first, and a residue's K1 runs
TWO = trace_of((K6, 0, 1100), (GEMM, 1000, 1700), (ADD, 1700, 2400),
               (K6, 2600, 3700), (GEMM, 3700, 4300), (K1, 4300, 4500), (ADD, 4500, 5200))


def test_roofline_reader_reads_the_busy_time():
    got = harness.load_reader("spmm_hybrid_roofline").read(record(TWO, SHAPE))
    bound = spmm_bound_s(SHAPE["nnz"], SHAPE["m"], SHAPE["k"], SHAPE["n"])
    assert got == pytest.approx(100.0 * bound / (5000 * US / 2))


def test_dia_reader_reads_k6_only():
    got = harness.load_reader("dia_device_ms.hybrid").read(record(TWO, SHAPE))
    assert got == pytest.approx(2200 * US / 2 * 1e3)


def test_dense_reader_reads_outside_the_spmm_kernels():
    got = harness.load_reader("hybrid_dense_device_ms").read(record(TWO, SHAPE))
    assert got == pytest.approx(2700 * US / 2 * 1e3)


NO_TRACES = [None, trace_of(), trace_of((K6, 0, 400), units=0)]
NO_TRACE_IDS = ["untraced", "no_device_work", "no_units"]


@pytest.mark.parametrize("metric", ["spmm_hybrid_roofline", "dia_device_ms.hybrid",
                                    "hybrid_dense_device_ms"])
@pytest.mark.parametrize("trace", NO_TRACES, ids=NO_TRACE_IDS)
def test_device_reader_reads_none_without_device_work(metric, trace):
    assert harness.load_reader(metric).read(record(trace, SHAPE)) is None


def test_dia_reader_reads_none_without_k6():
    tr = trace_of((GEMM, 0, 400), (K1, 400, 800))
    assert harness.load_reader("dia_device_ms.hybrid").read(record(tr, SHAPE)) is None


# ---- the loop's check ----

def loop_on(coo, hub_scale):
    """The cell's loop on ``coo`` at N on the CPU, the hub rows' values
    scaled by ``hub_scale`` so that they set max|C| by far."""
    conf = {**CELL, "n": N}
    traffic = harness.load_json(harness.BENCH_DIR / "traffic/hybrid_repeat.json")
    hubs = tx.split_structure(coo, n=N).head_rows
    vals = coo.vals * np.where(np.isin(coo.rows, hubs), np.float32(hub_scale), np.float32(1))
    pattern = harness.Pattern(coo.shape, coo.rows, coo.cols, vals.astype(np.float32))
    ctx = harness.Context(conf, traffic, 2**31 + 12345, torch.device("cpu"), pattern,
                          torch.as_tensor(pattern.vals))
    return hybrid_repeat.setup(ctx), hubs


def test_max_ulp_rest_sees_a_fault_outside_the_hubs(coo):
    loop, hubs = loop_on(coo, 2.0 ** 12)
    out = loop.step(0)
    rest = torch.ones(coo.shape[0], dtype=torch.bool)
    rest[torch.as_tensor(hubs.astype(np.int64))] = False
    faulty = out.clone()
    faulty[rest] = reference.tf32(faulty[rest])  # a lower precision outside the hubs
    assert torch.equal(faulty[~rest], out[~rest]) and not torch.equal(faulty, out)
    loop.release()
    sound = dict(loop.check([(0, out)]))
    found = dict(loop.check([(0, faulty)]))
    assert set(sound) == set(found) == set(LIMITS)
    assert all(sound[name] <= LIMITS[name] for name in LIMITS)
    assert found["max_ulp"] <= LIMITS["max_ulp"] < found["max_ulp_rest"]


def test_max_ulp_rest_reads_nan_for_another_shape(coo):
    loop, _ = loop_on(coo, 1.0)
    out = loop.step(0)
    loop.release()
    got = dict(loop.check([(0, out[:-1])]))
    assert np.isnan(got["max_ulp"]) and np.isnan(got["max_ulp_rest"])


# ---- on the card ----

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.gpu
def test_the_cell_at_full_size_on_the_card(cuda):
    """The stand-in at its published size, N = 512: one K6 launch a product,
    within FULL_MAX_ULP of the f64 reference over all rows and MAX_ULP over
    the rows outside the hubs, and the same bits under a profiler."""
    n = CELL["n"]
    coo = circuit_like(**CELL["matrix"]["args"])
    assert (coo.shape, coo.nnz) == ((CELL["rows"], CELL["cols"]), CELL["nnz"])
    split = tx.split_structure(coo, n=n)
    plan = plan_of(split, n, cuda)
    assert plan.dia_backend == "pallas" and plan.residue_plan is None
    b, c = operands(coo.shape[0], n, seed=3, device=cuda)
    before, hubs = profiling.launches(spmm_dia), profiling.launches(hybrid_hub)
    out = plan(b, ALPHA, BETA, c)
    torch.cuda.synchronize()
    assert profiling.launches(spmm_dia) == before + 1
    assert profiling.launches(hybrid_hub) == hubs + 1
    a, vals = a_of(coo, cuda)
    ref = reference.spmm(a, vals, b, c, ALPHA, BETA)
    rest = rest_rows(split, cuda)
    assert reference.ulp_gap(out, ref) <= FULL_MAX_ULP
    assert reference.ulp_gap(out[rest], ref[rest]) <= MAX_ULP
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        traced = plan(b, ALPHA, BETA, c)
        torch.cuda.synchronize()
    assert torch.equal(out, traced)
    assert profiling.launches(spmm_dia) == before + 2
    assert profiling.launches(hybrid_hub) == hubs + 2


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.fixture(scope="module")
def full_split(card):
    """The cell's stand-in at its published size and its split at N = 512."""
    return tx.split_structure(circuit_like(**CELL["matrix"]["args"]), n=CELL["n"])


def k6_out(plan, b, c):
    """The DIA kernel's output of a plain step: the hub pass's input."""
    with_c = c is not None
    c_in = c if with_c else torch.zeros(1, device=b.device).expand(plan.m, plan.n)
    return plan._dia(plan._dvals, plan._offsets, b, c_in, ALPHA, BETA if with_c else 0.0,
                     with_c=with_c, **plan._dia_kw)


@pytest.mark.gpu
@pytest.mark.parametrize("precise", [0, 1])
@pytest.mark.parametrize("with_c", [True, False])
@pytest.mark.parametrize("n,misaligned", [(512, False), (512, True), (37, False), (16, False)])
def test_the_hub_kernel_equals_its_plain_version(card, full_split, n, misaligned, with_c,
                                                 precise):
    """On the stand-in at full size, after K6 (K7 at N = 16): the kernel's
    output is its plain version's to the bit, plain and compensated,
    16-byte paths (N = 512) and scalar ones (N = 37, a misaligned B), and
    the plan's plain step is the plain kernel's."""
    plan = pallas_plan(full_split, n, card)
    lists = plan._hub
    assert lists.n_hub == full_split.head_rows.size and lists.entries == (
        full_split.head_nnz + full_split.head_row_nnz)
    b, c = operands(full_split.m, n, seed=11, device=card)
    if misaligned:  # B one float past a 16-byte boundary: the scalar path at N = 512
        b = torch.empty(b.numel() + 1, device=card)[1:].view_as(b).copy_(b)
        assert b.data_ptr() % 16
    c = c if with_c else None
    acc = k6_out(plan, b, c)
    before = profiling.launches(hybrid_hub)
    got = hybrid_hub(acc.clone(), b, ALPHA, lists, precise)
    torch.cuda.synchronize()
    assert profiling.launches(hybrid_hub) == before + 1
    want = hybrid_hub_ref(acc.clone(), b, ALPHA, lists, precise)
    assert torch.equal(got, want)
    assert not torch.equal(got, acc)
    if not precise:
        step = plan(b, ALPHA, BETA, c) if with_c else plan(b, ALPHA)
        assert torch.equal(step, want)


@pytest.mark.gpu
def test_a_plain_step_runs_k6_and_the_hub_kernel_alone(card, full_split):
    """Under ``torch.profiler`` a plain step with C launches K6 (its entry
    walk, which the plan takes on the cell's split) and the hub kernel,
    once each, and no GEMM and no elementwise pass;
    ``launch.hybrid_hub`` counts one launch a step, as ``hybrid.calls``
    counts the steps."""
    plan = pallas_plan(full_split, CELL["n"], card)
    b, c = operands(full_split.m, CELL["n"], seed=12, device=card)
    plan(b, ALPHA, BETA, c)
    torch.cuda.synchronize()
    before = tx.counters()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        # the card spins first, so that the trace is recording when the
        # first step's K6 (0.43 ms) runs: without it the profile lost that
        # kernel's record in three of four runs after the file's earlier tests
        torch.cuda._sleep(2_000_000)
        plan(b, ALPHA, BETA, c)
        plan.repeat(b, ALPHA, BETA, c, times=2)
        torch.cuda.synchronize()
    after = tx.counters()
    kernels = [e.name for e in prof.events()  # the spans' device ranges and the spin left out
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.name.startswith("sx.") and "spin_kernel" not in e.name]
    hub = [name for name in kernels if "hybrid_hub_kernel<" in name]
    dia = [name for name in kernels if "spmm_dia_entry_kernel<" in name]
    assert len(hub) == len(dia) == 3 and len(kernels) == 6, kernels
    assert not any("gemm" in name.lower() or "elementwise" in name for name in kernels)
    assert delta(before, after, "launch.hybrid_hub") == delta(before, after, "hybrid.calls") == 3


@pytest.mark.gpu
def test_the_precise_step_on_the_card_is_no_less_accurate_than_plain(card, full_split):
    """At full size on the card the precise step launches the hub kernel
    once a part (twice a step) and sums a hub row as the plain step does,
    so its gap from the f64 reference is no wider than plain mode's, over
    all rows and outside the hubs."""
    coo = circuit_like(**CELL["matrix"]["args"])
    n = CELL["n"]
    b, c = operands(coo.shape[0], n, seed=13, device=card)
    a, vals = a_of(coo, card)
    ref = reference.spmm(a, vals, b, c, ALPHA, BETA)
    rest = rest_rows(full_split, card)
    plain = pallas_plan(full_split, n, card)(b, ALPHA, BETA, c)
    plan = pallas_plan(full_split, n, card, precise=1)
    before = profiling.launches(hybrid_hub)
    out = plan(b, ALPHA, BETA, c)
    torch.cuda.synchronize()
    assert profiling.launches(hybrid_hub) == before + 2
    assert reference.ulp_gap(out, ref) <= reference.ulp_gap(plain, ref) <= FULL_MAX_ULP
    assert reference.ulp_gap(out[rest], ref[rest]) <= reference.ulp_gap(plain[rest], ref[rest])
