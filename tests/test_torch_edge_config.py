"""The edge stream as the benchmark's ``cant_edge_n512_p2`` runs it, on the
CPU at a small size: ``pack_edge`` with the cell's own ``spmm_config``
(``precise`` 2 kept; ``tile_m``, ``window_k`` and ``edge_chunk`` cut so that
the small matrix has several M-tiles, K-windows and chunks a job), then
``SpmmPlan(..., "edge", device="cpu")``.

* Level 2 against the benchmark's plain f64 reference
  (``bench_torch/reference.py``), with and without C: within half an ulp of
  max|C|, and every element the f32 nearest to its exact value (none above
  its own f32 representation floor). Level 0 reads above it.
* Level 2 where every sum cancels by about 2**24, against exact rationals:
  every element the f32 nearest to its exact value, which the compensated
  pair alone misses for most of them, so the elements that the check sends
  back to be summed again from f64 are what makes it so.
* The four ``edge.*`` counters: each equal to what a plain loop over the
  pack's slots gives, and each counted once however many plans share the
  pack.
* The benchmark's three readers of this cell (``bench_torch/metrics/``) on
  made-up records, and where what they read is absent.
"""

from __future__ import annotations

import torch_cpu  # noqa: F401  one torch thread per xdist worker

from fractions import Fraction

import numpy as np
import pytest
import torch

import sextans_tpu_torch as tx
from bench_torch import harness, reference
from bench_torch.roofline import spmm_bound_s
from bench_torch.trace import Op, Trace
from sextans_tpu_torch.format.pack_edge import PAD_BIT, ROW_END, ROW_SHIFT
from sextans_tpu_torch.ops import spmm_edge
from sextans_tpu_torch.utils import profiling
from sextans_tpu_torch.utils.matrices import fem_like

N = 40
ALPHA, BETA = 0.85, -2.06
CELL = harness.load_json(harness.ROOT / "bench_torch/configs/cant_edge_n512_p2.json")
# the cell's settings, precise level 2 among them, at the small matrix's scale:
# 5 M-tiles, 3 K-windows, 37 chunks
CFG = tx.SpmmConfig(**{**CELL["spmm_config"], "tile_m": 128, "window_k": 256,
                       "edge_chunk": 256})
# Level 2 rounds each element here to its nearest f32: within half an ulp
# of each element, so of max|C|. Readings here (seed 0): level 2 0.4242
# with C, 0.5000 without; level 0 0.8226 with C, 1.7103 without.
MAX_ULP = 0.5001
COUNTERS = ("edge.entries", "edge.slots", "edge.runs", "edge.rows")


@pytest.fixture(scope="module")
def coo():
    # 3 x 3 node blocks, 15 entries a row in a band of 400
    return fem_like(600, dofs=3, neighbors=5, seed=2)


def packed_of(coo, precise=2):
    return tx.pack_edge(coo, CFG.with_(precise=precise))


def test_the_cell_runs_level_2_on_unmasked_pads():
    assert CELL["spmm_config"]["precise"] == 2 and CFG.precise == 2
    assert not CFG.edge_masked and (CELL["format"], CELL["backend"]) == ("edge", "edge")


def test_the_pack_has_several_tiles_windows_and_chunks(coo):
    packed = packed_of(coo)
    assert packed.n_mtiles > 1 and packed.n_kwins > 1
    assert packed.n_chunks > packed.n_mtiles * packed.n_kwins


def operands(coo, seed=0):
    g = torch.Generator().manual_seed(seed)
    m, k = coo.shape
    return torch.randn(k, N, generator=g), torch.randn(m, N, generator=g)


def product(coo, precise, with_c):
    """The plan's output at ``precise`` and the f64 reference, with C or
    without it."""
    b, c = operands(coo)
    plan = tx.SpmmPlan(packed_of(coo, precise), N, "edge", device="cpu")
    a = reference.Coo(coo.shape, torch.as_tensor(coo.rows.astype(np.int64)),
                      torch.as_tensor(coo.cols.astype(np.int64)))
    vals = torch.as_tensor(coo.vals)
    if with_c:
        return plan(b, ALPHA, BETA, c), reference.spmm(a, vals, b, c, ALPHA, BETA)
    return plan(b, ALPHA), reference.spmm(a, vals, b, torch.zeros_like(c), ALPHA, 0.0)


@pytest.mark.parametrize("with_c", [True, False])
def test_level_2_is_correctly_rounded(coo, with_c):
    out, ref = product(coo, 2, with_c)
    assert reference.ulp_gap(out, ref) <= MAX_ULP
    floor = (ref.float().double() - ref).abs()
    assert int(((out.double() - ref).abs() > floor).sum()) == 0


@pytest.mark.parametrize("with_c", [True, False])
def test_level_0_reads_above_level_2(coo, with_c):
    plain = reference.ulp_gap(*product(coo, 0, with_c))
    precise = reference.ulp_gap(*product(coo, 2, with_c))
    assert plain > MAX_ULP and plain > 1.5 * precise


def cancelling_rows(n, seed=0, m=48, terms=20):
    """A matrix whose rows' sums cancel, with its B and a C that cancels
    ``ALPHA * A @ B`` to about a thousandth: each row holds ``terms`` normal
    entries and one entry 1 whose B row is minus their products' sum,
    rounded to f32, so each element of ``A @ B`` is about 2**-24 of its
    terms."""
    rng = np.random.default_rng(seed)
    k = m * (terms + 1)
    vals = rng.standard_normal(k).astype(np.float32)
    vals[terms::terms + 1] = 1.0
    b = rng.standard_normal((k, n)).astype(np.float32)
    prods = (vals[:, None].astype(np.float64) * b).reshape(m, terms + 1, n)
    b[terms::terms + 1] = -prods[:, :terms].sum(1)
    coo = tx.COOMatrix((m, k), np.repeat(np.arange(m, dtype=np.int32), terms + 1),
                       np.arange(k, dtype=np.int32), vals)
    ab = (vals[:, None].astype(np.float64) * b).reshape(m, terms + 1, n).sum(1)
    c = (-np.float32(ALPHA) * ab / np.float32(BETA)
         * (1 + 1e-3 * rng.standard_normal((m, n)))).astype(np.float32)
    return coo, b, c


def nearest_exact(coo, b, c=None):
    """``ALPHA * A @ B (+ BETA * C)`` in exact rationals, each element
    rounded to its nearest f32 (ties to even)."""
    alpha, beta = Fraction(float(np.float32(ALPHA))), Fraction(float(np.float32(BETA)))
    out = np.zeros((coo.shape[0], b.shape[1]), np.float32)
    for i in range(coo.shape[0]):
        at = np.flatnonzero(coo.rows == i)
        for j in range(b.shape[1]):
            y = alpha * sum(Fraction(float(coo.vals[e])) * Fraction(float(b[coo.cols[e], j]))
                            for e in at)
            if c is not None:
                y += beta * Fraction(float(c[i, j]))
            x = np.float32(float(y))
            out[i, j] = min((np.nextafter(x, np.float32(-np.inf)), x,
                             np.nextafter(x, np.float32(np.inf))),
                            key=lambda z: (abs(Fraction(float(z)) - y),
                                           int(np.array(z).view(np.int32)) & 1))
    return out


def cancelling_plan(lanes, n, device="cpu"):
    coo, b, c = cancelling_rows(n)
    cfg = CFG.with_(tile_m=16, window_k=256, edge_chunk=64, edge_lanes=lanes)
    return tx.SpmmPlan(tx.pack_edge(coo, cfg), n, "edge", device=device), coo, b, c


@pytest.mark.parametrize("lanes", [1, 4])
@pytest.mark.parametrize("with_c", [True, False])
def test_level_2_is_correctly_rounded_where_its_sums_cancel(with_c, lanes, monkeypatch):
    plan, coo, b, c = cancelling_plan(lanes, 8)
    want = nearest_exact(coo, b, c if with_c else None)

    def run():
        return (plan(b, ALPHA, BETA, c) if with_c else plan(b, ALPHA)).numpy()

    np.testing.assert_array_equal(run(), want)
    # the compensated pair alone rounds most of them the wrong way
    monkeypatch.setattr(spmm_edge, "_nearest_elements", lambda *args: None)
    assert (run() != want).mean() > 0.5


def by_hand(packed):
    """The four counters by a plain loop over the pack's slots: the slots
    that hold an entry (no pad bit), all slots, the runs (a run ends at each
    ``row_end`` slot) and the padded rows that one of them flushes into (the
    chunk's M-tile's first row plus the slot's row field)."""
    E = packed.config.edge_chunk
    entries = slots = runs = 0
    rows = set()
    for ch in range(packed.n_chunks):
        for w in packed.meta[ch, 0].view(np.uint32).tolist():
            slots += 1
            entries += not w & PAD_BIT
            if w & ROW_END:
                runs += 1
                rows.add(int(packed.chunk_mtile[ch]) * packed.config.tile_m + (w >> ROW_SHIFT))
    assert slots == packed.n_chunks * E
    return {"edge.entries": entries, "edge.slots": slots, "edge.runs": runs,
            "edge.rows": len(rows)}


def delta(before, after, name):
    return after.get(name, 0) - before.get(name, 0)


@pytest.fixture(scope="module")
def three_plans(coo):
    """The counters' change over three plans on one new pack."""
    packed = packed_of(coo)
    before = tx.counters()
    for _ in range(3):
        tx.SpmmPlan(packed, N, "edge", device="cpu")
    return packed, before, tx.counters()


@pytest.mark.parametrize("name", COUNTERS)
def test_counter_is_counted_once_a_pack(coo, three_plans, name):
    packed, before, after = three_plans
    want = by_hand(packed)[name]
    assert want > 0 and delta(before, after, name) == want


def test_counters_read_the_pack(coo, three_plans):
    packed, before, after = three_plans
    got = {name: delta(before, after, name) for name in COUNTERS}
    assert got["edge.entries"] == coo.nnz < got["edge.slots"]
    # every real row flushes at least once, and some rows more than once
    assert got["edge.rows"] == coo.shape[0] < got["edge.runs"]


# ---- the benchmark's readers of this cell ----

def record(trace=None, shape=None):
    return harness.Record(0.0, 1.0, 2, shape or {}, trace)


COUNTER_READERS = {  # metric -> (numerator, denominator, scale)
    "edge_fill_pct": ("edge.entries", "edge.slots", 100.0),
    "edge_runs_per_row": ("edge.runs", "edge.rows", 1.0),
}


@pytest.mark.parametrize("metric", sorted(COUNTER_READERS))
def test_counter_reader_reads_its_ratio(metric, monkeypatch):
    num, den, scale = COUNTER_READERS[metric]
    monkeypatch.setattr(profiling, "_COUNTERS", {num: 4007385, den: 4245504})
    got = harness.load_reader(metric).read(record())
    assert got == pytest.approx(scale * 4007385 / 4245504)


@pytest.mark.parametrize("missing", ["numerator", "denominator", "both", "zero"])
@pytest.mark.parametrize("metric", sorted(COUNTER_READERS))
def test_counter_reader_reads_none_without_its_counters(metric, missing, monkeypatch):
    num, den, _ = COUNTER_READERS[metric]
    held = {"numerator": {den: 9}, "denominator": {num: 9}, "both": {},
            "zero": {num: 0, den: 0}}[missing]
    monkeypatch.setattr(profiling, "_COUNTERS", held)
    assert harness.load_reader(metric).read(record()) is None


def test_counter_readers_on_a_cpu_plan(coo, monkeypatch):
    """After a fresh pack's plan on the CPU both readers read it."""
    monkeypatch.setattr(profiling, "_COUNTERS", {})
    packed = packed_of(coo)
    tx.SpmmPlan(packed, N, "edge", device="cpu")
    want = by_hand(packed)
    read = lambda metric: harness.load_reader(metric).read(record())  # noqa: E731
    assert read("edge_fill_pct") == pytest.approx(
        100.0 * want["edge.entries"] / want["edge.slots"])
    assert read("edge_runs_per_row") == pytest.approx(want["edge.runs"] / want["edge.rows"])


US = 1e-6
SHAPE = {"m": 62451, "k": 62451, "n": 512, "nnz": 4007385}


def trace_of(*ops, units=2):
    device = [Op(name, "kernel", t0 * US, t1 * US) for name, t0, t1 in ops]
    return Trace(device, [], [], 0.0, 4000 * US, units)


def test_roofline_reader_counts_k4_only():
    tr = trace_of(("void spmm_edge_kernel<2, true, false>(float const*, int const*)", 0, 1800),
                  ("void spmm_ell_kernel<3, 8, false>(float const*, int const*)", 1800, 2000),
                  ("Memcpy DtoD (Device -> Device)", 2000, 2100),
                  ("void at::native::vectorized_elementwise_kernel<4>(int)", 2100, 2200),
                  ("void spmm_edge_kernel<2, true, false>(float const*, int const*)", 2200, 4000))
    got = harness.load_reader("spmm_edge_roofline").read(record(tr, SHAPE))
    bound = spmm_bound_s(SHAPE["nnz"], SHAPE["m"], SHAPE["k"], SHAPE["n"])
    assert got == pytest.approx(100.0 * bound / (3600 * US / 2))


@pytest.mark.parametrize("trace", [
    None,
    trace_of(("void spmm_ell_kernel<3, 8, false>(float const*)", 0, 400)),
    trace_of(),
    trace_of(("void spmm_edge_kernel<2, true, false>(float const*)", 0, 400), units=0),
], ids=["untraced", "no_edge_kernel", "no_device_work", "no_units"])
def test_roofline_reader_reads_none_without_k4(trace):
    assert harness.load_reader("spmm_edge_roofline").read(record(trace, SHAPE)) is None
