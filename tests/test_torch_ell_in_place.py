"""The plan's ELL gather route at the operands' real size, on the CPU.

``SpmmPlan.__call__`` on the ``ell_pallas`` route hands the kernel (on the
CPU its plain version, ``spmm_ell_gather_padded_ref``) the caller's (K, N)
B and (M, N) C where they lie and takes back a fresh (M, N) output: no pad
of B or C, no slice. Held here to the padded route (``pad_b``, ``pad_c``,
the padded plain version, ``unpad``) value for value, on a matrix with hub
rows, one whose hub rows outgrow a kernel tile (``ell_tiles``'s long rows)
and one with no virtual row; with the counters ``plan.in_place`` and
``plan.pad_bytes`` and the benchmark's reader of them. ``repeat`` and a
call on (m_padded, N) operands still carry and return the padded rows.
"""

import torch_cpu  # noqa: F401  one torch thread per xdist worker

import numpy as np
import pytest
import torch

import sextans_tpu_torch as tx
from sextans_tpu_torch.ops.serve import bucketize_pack
from sextans_tpu_torch.ops.spmm_ell import (
    ell_tiles,
    spmm_ell_gather_padded,
    spmm_ell_gather_padded_ref,
)
from sextans_tpu_torch.utils import profiling

ALPHA, BETA = 0.85, -2.06
N = 24
KINDS = ["hub_rows", "long_rows", "no_virtual"]


def _hub_coo():
    # rows 5 and 600 hold 300 nonzeros each (tests/test_torch_gpu.py:_hub_matrix)
    rng = np.random.default_rng(5)
    rows = np.concatenate([np.full(300, 5), np.full(300, 600), rng.integers(0, 1030, 4000)])
    cols = rng.integers(0, 777, rows.size)
    vals = rng.standard_normal(rows.size).astype(np.float32)
    return tx.COOMatrix((1030, 777), rows, cols, vals)


def _pack(kind, precise=0):
    """``hub_rows``: R = 8, the hub rows spill into virtual rows; ``long_rows``:
    R = 4, rows 5 and 600 take 75 padded rows each, more than a tile holds;
    ``no_virtual``: a banded matrix whose rows all fit R = 32."""
    cfg = tx.SpmmConfig(tile_m=64, precise=precise)
    if kind == "no_virtual":
        coo = tx.COOMatrix.random(300, 260, 3000, seed=2, banded=True, bandwidth=40)
        packed = tx.pack_ell(coo, cfg, slots_per_row=32)
    else:
        coo = _hub_coo()
        packed = tx.pack_ell(coo, cfg, slots_per_row=8 if kind == "hub_rows" else 4)
    long_rows = ell_tiles(packed).long_rows.size
    assert (packed.n_virt > 0, long_rows > 0) == {
        "hub_rows": (True, False), "long_rows": (True, True), "no_virtual": (False, False)}[kind]
    return coo, packed


def _operands(m, k, seed=0):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.standard_normal((k, N)).astype(np.float32)),
            torch.from_numpy(rng.standard_normal((m, N)).astype(np.float32)))


def _padded_route(pl, b, c, precise):
    """The parent's route: B and C padded, the padded kernel, the slice."""
    c_p = pl.no_c() if c is None else pl.pad_c(c)
    out = spmm_ell_gather_padded_ref(*pl.arrays, pl.pad_b(b), c_p, ALPHA,
                                     0.0 if c is None else BETA, m_base=pl.packed.m_base,
                                     with_c=c is not None, precise=precise)
    assert out.shape == (pl.packed.m_padded, N)
    return pl.unpad(out)


def _own(t, shape):
    """``t`` is ``shape``, f32, and holds its own storage, no view of a larger one."""
    return (tuple(t.shape) == shape and t._base is None and t.is_contiguous()
            and t.untyped_storage().nbytes() == 4 * int(np.prod(shape)))


@pytest.mark.parametrize("precise", [0, 1])
@pytest.mark.parametrize("with_c", [True, False])
@pytest.mark.parametrize("kind", KINDS)
def test_in_place_call_equals_the_padded_route(kind, with_c, precise):
    coo, packed = _pack(kind, precise)
    pl = tx.plan(packed, N, "ell_pallas", device="cpu")
    b, c = _operands(*coo.shape)
    b0, c0 = b.clone(), c.clone()
    args = (b, ALPHA, BETA, c) if with_c else (b, ALPHA)
    got = pl(*args)
    assert _own(got, coo.shape[:1] + (N,))
    want = _padded_route(pl, b, c if with_c else None, precise)
    assert torch.equal(got, want)
    assert torch.equal(b, b0) and torch.equal(c, c0)  # the caller's operands, read only
    exact = tx.golden_spmm_exact(tx.CSRMatrix.from_coo(coo), b.numpy(), ALPHA,
                                 BETA if with_c else 0.0, c.numpy() if with_c else None)
    assert tx.verify(exact, got.numpy()).passed


@pytest.mark.parametrize("kind", KINDS)
def test_in_place_counters_and_no_pad_bytes(kind, monkeypatch):
    """Three calls with C and two without: each counted in ``plan.calls``
    and ``plan.in_place``, and none makes a padded byte. The slab route on
    the same matrix takes B and C in place too, and the plain ``ell``
    engine keeps its C pad (its B has K rows already, and is not copied)."""
    coo, packed = _pack(kind)
    monkeypatch.setattr(profiling, "_COUNTERS", {})
    b, c = _operands(*coo.shape)
    pl = tx.plan(packed, N, "ell_pallas", device="cpu")
    for _ in range(3):
        pl(b, ALPHA, BETA, c)
    for _ in range(2):
        pl(b, ALPHA)
    got = tx.counters()
    assert (got["plan.calls"], got["plan.in_place"], got["plan.pad_bytes"]) == (5, 5, 0)
    cfg = tx.SpmmConfig(tile_m=128, window_k=256, block_k=8, group_blocks=8)
    slab = tx.plan(tx.pack_mxu(coo, cfg), N, "mxu", device="cpu")
    assert slab.packed.k_padded > coo.shape[1] and slab.packed.m_padded > coo.shape[0]
    monkeypatch.setattr(profiling, "_COUNTERS", {})
    slab(b, ALPHA, BETA, c)
    slab(b, ALPHA)
    assert tx.counters() == {"plan.calls": 2, "plan.in_place": 2, "plan.pad_bytes": 0}
    ell = tx.plan(packed, N, "ell", device="cpu")
    monkeypatch.setattr(profiling, "_COUNTERS", {})
    ell(b, ALPHA, BETA, c)
    ell(b, ALPHA)
    assert ell.packed.k_padded == coo.shape[1]
    assert tx.counters() == {"plan.calls": 2, "plan.pad_bytes": 4 * N * ell.packed.m_padded}


@pytest.mark.parametrize("counters,want", [
    ({}, None),  # a program with no counters
    ({"plan.calls": 4}, None),  # one with no in-place route: the parent's
    ({"plan.calls": 0, "plan.in_place": 0}, None),
    ({"plan.calls": 4, "plan.in_place": 4}, 100.0),
    ({"plan.calls": 8, "plan.in_place": 2}, 25.0),
])
def test_plan_in_place_pct_reader(counters, want, monkeypatch):
    from bench_torch import harness

    monkeypatch.setattr(profiling, "_COUNTERS", dict(counters))
    record = harness.Record(0.0, 1.0, 2, {}, None)
    assert harness.load_reader("plan_in_place_pct").read(record) == want


def test_plan_in_place_pct_reads_a_run(monkeypatch):
    from bench_torch import harness

    coo, packed = _pack("hub_rows")
    monkeypatch.setattr(profiling, "_COUNTERS", {})
    b, c = _operands(*coo.shape)
    tx.plan(packed, N, "ell_pallas", device="cpu")(b, ALPHA, BETA, c)
    record = harness.Record(0.0, 1.0, 1, {}, None)
    assert harness.load_reader("plan_in_place_pct").read(record) == 100.0
    assert harness.load_reader("plan_copy_mb.repeat").read(record) == 0.0


@pytest.mark.parametrize("precise", [0, 1])
@pytest.mark.parametrize("kind", KINDS)
def test_repeat_and_padded_calls_carry_the_padded_rows(kind, precise):
    """``repeat`` carries the whole padded C, virtual rows included, through
    the padded kernel, as before; a call on (m_padded, N) operands returns
    every padded row, its real rows the in-place call's values."""
    coo, packed = _pack(kind, precise)
    pl = tx.plan(packed, N, "ell_pallas", device="cpu")
    b, c = _operands(*coo.shape, seed=1)
    b_p, c_p = pl.pad_b(b), pl.pad_c(c)
    kw = dict(m_base=packed.m_base, precise=precise)
    padded = spmm_ell_gather_padded(*pl.arrays, b_p, c_p, ALPHA, BETA, **kw)
    assert padded.shape == (packed.m_padded, N)
    assert torch.equal(padded[:coo.shape[0]], pl(b, ALPHA, BETA, c))
    carry = c_p
    for _ in range(3):
        carry = spmm_ell_gather_padded(*pl.arrays, b_p, carry, ALPHA, BETA, **kw)
    assert torch.equal(pl.repeat(b, ALPHA, BETA, c, times=3), carry[:coo.shape[0]])
    # a padded C's virtual rows are read: they change the virtual rows' own
    # output and, through the fold's beta term, nothing else
    if packed.n_virt:
        poked = c_p.clone()
        poked[packed.m_base:] += 1.0
        again = spmm_ell_gather_padded(*pl.arrays, b_p, poked, ALPHA, BETA, **kw)
        assert not torch.equal(again[packed.m_base:], padded[packed.m_base:])


def test_in_place_call_on_a_reordered_pack(monkeypatch):
    """A pack of A's rows and columns permuted (``row_perm``, ``col_perm``):
    B and C are gathered, not padded, the gathers are counted in
    ``plan.pad_bytes``, and the answer is A's."""
    coo, _ = _pack("hub_rows")
    m, k = coo.shape
    rng = np.random.default_rng(9)
    row_perm, col_perm = rng.permutation(m), rng.permutation(k)
    inv_row, inv_col = np.argsort(row_perm), np.argsort(col_perm)
    permuted = tx.COOMatrix(coo.shape, inv_row[coo.rows], inv_col[coo.cols], coo.vals)
    packed = tx.pack_ell(permuted, tx.SpmmConfig(tile_m=64), slots_per_row=8)
    packed.row_perm, packed.col_perm = row_perm, col_perm
    pl = tx.plan(packed, N, "ell_pallas", device="cpu")
    b, c = _operands(m, k, seed=2)
    monkeypatch.setattr(profiling, "_COUNTERS", {})
    got = pl(b, ALPHA, BETA, c)
    pl(b, ALPHA)
    assert tx.counters() == {"plan.calls": 2, "plan.in_place": 2,
                             "plan.pad_bytes": 4 * N * (2 * k + m)}
    assert tuple(got.shape) == (m, N)
    assert torch.equal(got, _padded_route(pl, b, c, 0))
    exact = tx.golden_spmm_exact(tx.CSRMatrix.from_coo(coo), b.numpy(), ALPHA, BETA,
                                 c.numpy())
    assert tx.verify(exact, got.numpy()).passed


def test_a_bucketized_pack_keeps_the_padded_route(monkeypatch):
    """A served pack (``m_base`` past ``m``) is not taken in place: its plan
    pads as before and its real rows are the unbucketed plan's."""
    coo, packed = _pack("hub_rows")
    served = bucketize_pack(packed)
    assert served.m_base > served.m
    b, c = _operands(*coo.shape, seed=3)
    monkeypatch.setattr(profiling, "_COUNTERS", {})
    pl = tx.SpmmPlan(served, N, "ell_pallas", device="cpu")
    got = pl(b, ALPHA, BETA, c)
    assert "plan.in_place" not in tx.counters()
    assert served.k_padded == served.k  # B is not copied; C is padded as before
    assert tx.counters()["plan.pad_bytes"] == 4 * N * served.m_padded
    assert torch.equal(got, tx.plan(packed, N, "ell_pallas", device="cpu")(b, ALPHA, BETA, c))


@pytest.mark.parametrize("precise", [0, 1])
@pytest.mark.parametrize("past_m", ["some_virtual", "all_virtual", "some_pads"])
def test_plain_twin_takes_any_row_count_up_to_m_padded(past_m, precise):
    """C and the output with rows from M up to m_padded: a padded row that C
    holds takes its C term, the rest none; the result equals a zero pad of
    that C to m_padded, row for row."""
    coo, packed = _pack("hub_rows", precise)
    pl = tx.plan(packed, N, "ell_pallas", device="cpu")
    m, n_virt = packed.m_base, packed.n_virt
    rows = {"some_virtual": m + n_virt // 2, "all_virtual": m + n_virt,
            "some_pads": (m + n_virt + packed.m_padded) // 2}[past_m]
    assert m < rows < packed.m_padded
    b, _ = _operands(*coo.shape)
    c = torch.from_numpy(np.random.default_rng(4).standard_normal((rows, N)).astype(np.float32))
    kw = dict(m_base=m, precise=precise)
    got = spmm_ell_gather_padded_ref(*pl.arrays, b, c, ALPHA, BETA, **kw)
    assert _own(got, (rows, N))
    zero_pad = torch.cat([c, torch.zeros((packed.m_padded - rows, N))])
    want = spmm_ell_gather_padded_ref(*pl.arrays, b, zero_pad, ALPHA, BETA, **kw)
    assert torch.equal(got, want[:rows])


@pytest.mark.parametrize("kind", KINDS)
def test_in_place_operands_are_the_callers(kind):
    """On the route, B and C reach the kernel as the caller's own tensors:
    no clone, no pad; a strided C is made contiguous, and the default
    targets still pad C to m_padded (``repeat``, the value op)."""
    coo, packed = _pack(kind)
    pl = tx.plan(packed, N, "ell_pallas", device="cpu")
    b, c = _operands(*coo.shape)
    assert pl.pad_b(b) is b and pl.pad_c(c, pl.m) is c
    strided = torch.from_numpy(np.asfortranarray(c.numpy()))
    assert not strided.is_contiguous()
    assert torch.equal(pl.pad_c(strided, pl.m), c) and pl.pad_c(strided, pl.m).is_contiguous()
    assert pl.pad_c(c).shape == pl.no_c().shape == (packed.m_padded, N)
    assert pl.no_c(pl.m).shape == (coo.shape[0], N)
