"""Precise mode of the ELL and DIA engines and of the hybrid plan, on the CPU.

The same inputs, made from numpy seeds, go through the JAX package and the
port:

* K5: the plain version ``spmm_ell_gather_padded_ref(precise=1)`` against
  the JAX ``spmm_ell_gather_padded(interpret=True, precise=True)`` under
  ``jax.enable_x64`` (which gives the JAX package its f64 hub fold), on a
  hub-heavy matrix, with and without C;
* ``ell``: ``spmm_ell_padded_ref(precise=1)`` against the JAX
  ``spmm_ell_padded(precise=True)`` under x64;
* K6 / K7: ``spmm_dia_ref(precise=1)`` against the JAX ``spmm_dia_padded``
  and ``spmm_dia_ct_padded(interpret=True, precise=True)`` on B padded as the
  JAX hybrid plan pads it, with offsets that straddle blocks;
* ``HybridSpmmPlan(device="cpu", precise=1|2)`` against the JAX plan with
  the ``pallas_interpret`` DIA engine and the same residue.

Tolerances: 2 ulp of max|C| against the JAX package (its CPU faithful band:
XLA:CPU contracts the EFT sums, ``sextans_tpu/ops/df32.py:61-71``), and 4 on
the hybrid's hub rows, whose long f32 dot products neither package
compensates and the two sum in another order. Against
``golden_spmm_exact``: ``ell_pallas`` 1.0 ulp (each virtual hub row rounds to
f32 before the f64 fold), ``ell`` 0.5001 ulp (f64 throughout), the DIA part
1.0 ulp, and the hybrid plan no worse than the port's plain hybrid (its head
and hub-row matmuls are uncompensated in both packages).
"""

import torch_cpu  # noqa: F401  one torch thread per xdist worker

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sextans_tpu_torch as tx
from sextans_tpu.format.coo import COOMatrix as RefCOO
from sextans_tpu.format.csr import CSRMatrix as RefCSR
from sextans_tpu.format.pack_ell import pack_ell as ref_pack_ell
from sextans_tpu.ops import hybrid as ref_hybrid
from sextans_tpu.ops.golden import golden_spmm_exact
from sextans_tpu.ops.plan import SpmmPlan as RefPlan
from sextans_tpu.ops.spmm_dia_pallas import spmm_dia_ct_padded, spmm_dia_padded
from sextans_tpu.ops.spmm_ell_pallas import spmm_ell_gather_padded as jax_ell_gather
from sextans_tpu.ops.spmm_ell_xla import spmm_ell_padded as jax_ell_xla
from sextans_tpu.utils.config import SpmmConfig as RefConfig
from sextans_tpu_torch.format.convert import from_reference
from sextans_tpu_torch.ops.df32 import two_prod
from sextans_tpu_torch.ops.launch import fma_f32
from sextans_tpu_torch.ops.spmm_dia import spmm_dia, spmm_dia_ref, spmm_dia_skinny
from sextans_tpu_torch.ops.spmm_ell import (
    spmm_ell_gather_padded,
    spmm_ell_gather_padded_ref,
    spmm_ell_padded_ref,
)
from sextans_tpu_torch.utils.profiling import launches

ALPHA, BETA = 0.85, -2.06


def _ulp(exact):
    return float(np.spacing(np.float32(np.abs(exact).max())))


def _err(got, exact):
    return float(np.abs(np.asarray(got, dtype=np.float64) - exact).max())


def _coo(m, k, rows, cols, rng):
    """Both packages' COO of the deduplicated (rows, cols), values from
    ``rng`` (tests/test_df32.py's construction)."""
    lin = np.unique(np.asarray(rows, np.int64) * k + np.asarray(cols, np.int64))
    r, c = (lin // k).astype(np.int32), (lin % k).astype(np.int32)
    vals = rng.standard_normal(lin.size).astype(np.float32)
    return RefCOO((m, k), r, c, vals), tx.COOMatrix((m, k), r, c, vals)


def _hub_heavy():
    """tests/test_df32.py:128-156: row 7 holds ~1,500 of 4,000 nonzeros, so
    the ELL pack folds many virtual rows into it."""
    rng = np.random.default_rng(5)
    m = k = 256
    rows = rng.integers(0, m, 4000).astype(np.int32)
    rows[:1500] = 7
    cols = rng.integers(0, k, 4000).astype(np.int32)
    ref, port = _coo(m, k, rows, cols, rng)
    b = rng.standard_normal((k, 16)).astype(np.float32)
    c = rng.standard_normal((m, 16)).astype(np.float32)
    return ref, port, b, c


def _diag_hub_residue():
    """tests/test_df32.py:159-197: two diagonals, a hub column and a
    scattered residue."""
    rng = np.random.default_rng(6)
    m = k = 384
    d = np.arange(m, dtype=np.int32)
    rows = np.concatenate([d, d[:-1], d, rng.integers(0, m, 2000)])
    cols = np.concatenate([d, d[:-1] + 1, np.full(m, 11), rng.integers(0, k, 2000)])
    return _coo(m, k, rows, cols, rng)


def _mixed(m=600):
    """tests/test_torch_hybrid.py's mixed matrix: two diagonals, a hub
    column, two 100-term hub rows and a random residue."""
    rng = np.random.default_rng(5)
    base = np.arange(m)
    rows = [base, base[:-3], rng.integers(0, m, 800), rng.integers(0, m, 3000),
            np.repeat([5, m // 2], 100)]
    cols = [base, base[:-3] + 3, rng.integers(0, m, 800), np.full(3000, 17),
            rng.integers(0, m, 200)]
    return _coo(m, m, np.concatenate(rows), np.concatenate(cols), rng)


def _stencil(m=500, offsets=(-7, -1, 0, 1, 7)):
    base = np.arange(m)
    rows = np.concatenate([base[(base + o >= 0) & (base + o < m)] for o in offsets])
    cols = np.concatenate([base[(base + o >= 0) & (base + o < m)] + o for o in offsets])
    return _coo(m, m, rows, cols, np.random.default_rng(0))


def _nonsquare():
    base = np.arange(300)
    return _coo(300, 500, np.concatenate([base, base]), np.concatenate([base + 150, base + 10]),
                np.random.default_rng(1))


def test_two_prod_error_is_the_fma_to_the_bit():
    """``two_prod``'s error term, ``a * b - p`` in f64, is ``fma(a, b, -p)``
    rounded once, as the kernels' ``__fmaf_rn`` gives it: across the f32
    range, subnormal products and overflow included."""
    rng = np.random.default_rng(12)
    a = (rng.standard_normal(20000) * 10.0 ** rng.integers(-40, 39, 20000)).astype(np.float32)
    b = (rng.standard_normal(20000) * 10.0 ** rng.integers(-40, 39, 20000)).astype(np.float32)
    a[:3], b[:3] = [np.inf, 0.0, 3e38], [2.0, np.inf, 7.0]
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    p, e = two_prod(ta, tb)
    want = fma_f32(ta, tb, -p)
    with np.errstate(over="ignore", invalid="ignore"):
        np.testing.assert_array_equal(p.numpy().view(np.int32), (a * b).view(np.int32))
    np.testing.assert_array_equal(e.numpy()[:3], [np.nan, np.nan, -np.inf])
    np.testing.assert_array_equal(e.numpy().view(np.int32)[3:], want.numpy().view(np.int32)[3:])
    assert (np.abs(a * b.astype(np.float64)) < np.finfo(np.float32).tiny).sum() > 100


# ---- K5 and the ell engine ----

def _ell_packs(ref_coo, tile_m=256, r=None):
    ref = ref_pack_ell(ref_coo, RefConfig(tile_m=tile_m, precise=1), slots_per_row=r)
    return ref, from_reference(ref)


@pytest.mark.parametrize("with_c", [True, False])
def test_ell_gather_precise_matches_jax_kernel(with_c):
    ref_coo, coo, b, c = _hub_heavy()
    ref, port = _ell_packs(ref_coo)
    assert port.n_virt > 0 and port.config.precise == 1
    m, n = coo.shape[0], b.shape[1]
    beta = BETA if with_c else 0.0
    c_p = np.zeros((port.m_padded, n), np.float32)
    c_p[:m] = c
    with jax.enable_x64(True):
        want = np.asarray(jax_ell_gather(
            jnp.asarray(ref.vals), jnp.asarray(ref.cols), jnp.asarray(ref.fold_rows),
            jnp.pad(jnp.asarray(b), ((0, 0), (0, 128 - n))),
            jnp.pad(jnp.asarray(c_p), ((0, 0), (0, 128 - n))),
            jnp.float32(ALPHA), jnp.float32(beta), m_block=256, m_base=ref.m_base,
            with_c=with_c, interpret=True, precise=True))[:m, :n]
    arrays = [torch.from_numpy(np.ascontiguousarray(a)) for a in
              (port.vals, port.cols.astype(np.int32), port.fold_rows.astype(np.int32))]
    got = spmm_ell_gather_padded_ref(*arrays, torch.from_numpy(b), torch.from_numpy(c_p),
                                     ALPHA, beta, m_base=port.m_base, with_c=with_c,
                                     precise=1)[:m].numpy()
    exact = golden_spmm_exact(RefCSR.from_coo(ref_coo), b, ALPHA, beta,
                              c if with_c else None)
    assert np.isfinite(got).all()
    assert _err(got, want) <= 2 * _ulp(exact)
    assert _err(got, exact) <= 1.0 * _ulp(exact)
    # the wrapper on a CPU tensor is the plain version, launching nothing
    before = launches(spmm_ell_gather_padded)
    via = spmm_ell_gather_padded(*arrays, torch.from_numpy(b), torch.from_numpy(c_p), ALPHA,
                                 beta, m_base=port.m_base, with_c=with_c, precise=2)
    assert torch.equal(via[:m], torch.from_numpy(got))
    assert launches(spmm_ell_gather_padded) == before


@pytest.mark.parametrize("with_c", [True, False])
def test_ell_precise_matches_jax_engine_and_f64(with_c):
    ref_coo, coo, b, c = _hub_heavy()
    ref, port = _ell_packs(ref_coo, tile_m=64, r=8)
    m, n = coo.shape[0], b.shape[1]
    beta = BETA if with_c else 0.0
    c_p = np.zeros((port.m_padded, n), np.float32)
    c_p[:m] = c
    with jax.enable_x64(True):
        want = np.asarray(jax_ell_xla(
            jnp.asarray(ref.vals), jnp.asarray(ref.cols), jnp.asarray(ref.fold_rows),
            jnp.asarray(b), jnp.asarray(c_p), jnp.float32(ALPHA), jnp.float32(beta),
            m_block=64, m_base=ref.m_base, with_c=with_c, precise=True))[:m]
    arrays = [torch.from_numpy(np.ascontiguousarray(a)) for a in
              (port.vals, port.cols.astype(np.int32), port.fold_rows.astype(np.int32))]
    got = spmm_ell_padded_ref(*arrays, torch.from_numpy(b), torch.from_numpy(c_p), ALPHA,
                              beta, m_base=port.m_base, with_c=with_c, precise=1)[:m].numpy()
    exact = golden_spmm_exact(RefCSR.from_coo(ref_coo), b, ALPHA, beta,
                              c if with_c else None)
    assert _err(got, want) <= 2 * _ulp(exact)
    assert _err(got, exact) <= 0.5001 * _ulp(exact)


@pytest.mark.parametrize("precise", [1, 2])
@pytest.mark.parametrize("backend", ["ell", "ell_pallas"])
def test_ell_precise_plan_matches_jax_plan(backend, precise):
    ref_coo, coo, b, c = _hub_heavy()
    cfg = dict(tile_m=64, precise=precise)
    ref = ref_pack_ell(ref_coo, RefConfig(**cfg), slots_per_row=8)
    port = tx.pack_ell(coo, tx.SpmmConfig(**cfg), slots_per_row=8)
    jax_backend = {"ell": "ell", "ell_pallas": "ell_pallas_interpret"}[backend]
    with jax.enable_x64(True):
        want = np.asarray(RefPlan(ref, 16, backend=jax_backend)(b, ALPHA, BETA, c))
    pl = tx.plan(port, 16, backend, device="cpu")
    got = pl(b, ALPHA, BETA, c).numpy()
    exact = golden_spmm_exact(RefCSR.from_coo(ref_coo), b, ALPHA, BETA, c)
    bar = 0.5001 if backend == "ell" else 1.0
    assert tx.verify(exact, got).passed
    assert _err(got, want) <= 2 * _ulp(exact)
    assert _err(got, exact) <= bar * _ulp(exact)
    plain = tx.plan(tx.pack_ell(coo, tx.SpmmConfig(tile_m=64), slots_per_row=8), 16, backend,
                    device="cpu")(b, ALPHA, BETA, c).numpy()
    assert _err(got, exact) <= _err(plain, exact)
    # the repeat carry holds the virtual rows (ell_pallas strips their
    # beta * C in the fold, ell never reads them): three chained calls
    with jax.enable_x64(True):
        want = np.asarray(RefPlan(ref, 16, backend=jax_backend).repeat(b, ALPHA, BETA, c,
                                                                       times=3))
    chained = pl.repeat(b, ALPHA, BETA, c, times=3)
    three = pl(b, ALPHA, BETA, pl(b, ALPHA, BETA, pl(b, ALPHA, BETA, c)))
    assert _err(chained.numpy(), want) <= 2 * _ulp(want)
    if backend == "ell":
        assert torch.equal(chained, three)
    assert _err(chained.numpy(), three.numpy()) <= 1.0 * _ulp(want)


@pytest.mark.parametrize("precise", [1, 2])
def test_ell_gather_precise_selects_out_pads_with_nonfinite_b(precise):
    """B's row 0 infinite and A without column 0: only pad slots read it,
    and a value-0 slot is selected out, so every element stays finite."""
    ref_coo, coo, b, c = _hub_heavy()
    keep = coo.cols != 0
    coo = tx.COOMatrix(coo.shape, coo.rows[keep], coo.cols[keep], coo.vals[keep])
    packed = tx.pack_ell(coo, tx.SpmmConfig(tile_m=64, precise=precise), slots_per_row=8)
    b = b.copy()
    b[0] = np.inf
    got = tx.plan(packed, 16, "ell_pallas", device="cpu")(b, ALPHA, BETA, c).numpy()
    assert np.isfinite(got).all()
    b[0] = 0.0
    exact = tx.golden_spmm_exact(tx.CSRMatrix.from_coo(coo), b, ALPHA, BETA, c)
    assert _err(got, exact) <= 1.0 * _ulp(exact)


# ---- K6 and K7 ----

def _dia_operands(n):
    """tests/test_torch_hybrid.py's DIA operands: offsets straddling 64-row
    blocks and a negative one; dvals zero where i + off leaves A."""
    rng = np.random.default_rng(4)
    m = k = 160
    offsets = (-70, -1, 0, 3, 65)
    dvals = rng.standard_normal((len(offsets), m)).astype(np.float32)
    for j, off in enumerate(offsets):
        dvals[j, (np.arange(m) + off < 0) | (np.arange(m) + off >= k)] = 0.0
    rng = np.random.default_rng(n)
    b = rng.standard_normal((k, n)).astype(np.float32)
    c = rng.standard_normal((m, n)).astype(np.float32)
    a = np.zeros((m, k))
    for j, off in enumerate(offsets):
        i = np.arange(max(0, -off), min(m, k - off))
        a[i, i + off] = dvals[j, i]
    return offsets, dvals, b, c, a


@pytest.mark.parametrize("with_c", [True, False])
@pytest.mark.parametrize("route,n", [("ct", 16), ("ct", 13), ("standard", 40)])
def test_dia_precise_matches_jax_kernels(route, n, with_c):
    offsets, dvals, b, c, a = _dia_operands(n)
    m, tile_m, pad_lo, m_pad = 160, 64, 70, 192
    beta = BETA if with_c else 0.0
    exact = ALPHA * (a @ b.astype(np.float64)) + (beta * c.astype(np.float64) if with_c else 0)
    dv_pad = np.zeros((len(offsets), m_pad), np.float32)
    dv_pad[:, :m] = dvals
    ab = (jnp.float32(ALPHA), jnp.float32(beta))
    if route == "ct":  # as hybrid.py:533-536 pads B^T and C^T
        n_ct = -(-n // 8) * 8
        bt = jnp.pad(jnp.asarray(b.T), ((0, n_ct - n), (pad_lo, 0)))
        ct = jnp.pad(jnp.asarray(c.T), ((0, n_ct - n), (0, m_pad - m)))
        want = np.asarray(spmm_dia_ct_padded(
            jnp.asarray(dv_pad), bt, ct, *ab, offsets=offsets, tile_m=tile_m,
            interpret=True, with_c=with_c, precise=True)).T[:m, :n]
    else:  # as hybrid.py:554 pads B
        bp = jnp.pad(jnp.asarray(b), ((pad_lo, 0), (0, 128 - n)))
        cp = jnp.pad(jnp.asarray(c), ((0, m_pad - m), (0, 128 - n)))
        want = np.asarray(spmm_dia_padded(
            jnp.asarray(np.ascontiguousarray(dv_pad.T)), bp, cp, *ab, offsets=offsets,
            tile_m=tile_m, tile_n=128, interpret=True, with_c=with_c, precise=True))[:m, :n]
    c_t = torch.from_numpy(c) if with_c else torch.zeros(1).expand(m, n)
    args = (torch.from_numpy(dvals), torch.tensor(offsets, dtype=torch.int32),
            torch.from_numpy(b), c_t, ALPHA, beta)
    got = spmm_dia_ref(*args, with_c=with_c, precise=1)
    assert got.shape == (m, n)
    assert _err(got.numpy(), want) <= 2 * _ulp(exact)
    assert _err(got.numpy(), exact) <= 1.0 * _ulp(exact)
    plain = spmm_dia_ref(*args, with_c=with_c).numpy()
    assert _err(got.numpy(), exact) <= _err(plain, exact)
    # both wrappers run the plain version on CPU tensors, at either level
    before = (launches(spmm_dia), launches(spmm_dia_skinny))
    for fn in (spmm_dia, spmm_dia_skinny):
        assert torch.equal(fn(*args, with_c=with_c, precise=2), got)
    assert (launches(spmm_dia), launches(spmm_dia_skinny)) == before


def test_dia_precise_keeps_a_long_cancelling_sum():
    """40 diagonals whose products cancel to a small sum: plain FFMA loses
    it to the large partial sums, the compensated sum keeps it."""
    rng = np.random.default_rng(2)
    m = k = 300
    offsets = np.arange(-20, 20, dtype=np.int32)
    dvals = (rng.standard_normal((40, m)) * 10.0 ** rng.integers(-3, 4, (40, m))).astype(
        np.float32)
    b = rng.standard_normal((k, 8)).astype(np.float32)
    a = np.zeros((m, k))
    for j, off in enumerate(offsets):
        i = np.arange(max(0, -off), min(m, k - off))
        a[i, i + off] = dvals[j, i]
        dvals[j, np.setdiff1d(np.arange(m), i)] = 0.0
    exact = a @ b.astype(np.float64)
    args = (torch.from_numpy(dvals), torch.from_numpy(offsets), torch.from_numpy(b),
            torch.zeros(1).expand(m, 8), 1.0, 0.0)
    precise = spmm_dia_ref(*args, with_c=False, precise=1).numpy()
    plain = spmm_dia_ref(*args, with_c=False).numpy()
    floor = np.abs(exact.astype(np.float32).astype(np.float64) - exact)
    assert (np.abs(precise - exact) <= floor + 1e-300).mean() > 0.99
    assert _err(precise, exact) < _err(plain, exact)


# ---- the precise hybrid plan ----

RESIDUE = {  # port backend -> (JAX backend, residue format, config)
    "pallas": ("pallas_interpret", "vpu",
               dict(tile_m=64, window_k=128, block_k=8, group_blocks=16)),
    "mxu": ("mxu_interpret", "mxu",
            dict(tile_m=128, window_k=128, block_k=16, group_blocks=4)),
    "edge": ("edge_interpret", "edge",
             dict(tile_m=64, window_k=128, edge_chunk=64, edge_lanes=2)),
    "ell_pallas": ("ell_pallas_interpret", "ell", dict(tile_m=64, ell_r=4)),
}
MATRICES = {"df32": _diag_hub_residue, "mixed": _mixed, "stencil": _stencil,
            "nonsquare": _nonsquare}


def _hub_rows_apart(got, want, split, ulp):
    """``got`` against ``want`` within 2 ulp of max|C| on every row but the
    hub rows, and within 4 on those: a hub row is one f32 dot product as long
    as the row, uncompensated in both packages, and the port's matmul (MKL
    on the CPU) sums its ~100 terms in another order than XLA's dot (the
    bar of tests/test_torch_hybrid.py)."""
    d = np.abs(np.asarray(got, np.float64) - want)
    rest = np.ones(d.shape[0], bool)
    rest[split.head_rows] = False
    assert d[rest].max(initial=0.0) <= 2 * ulp
    assert d.max() <= 4 * ulp


def _hybrid_plans(matrix, n, backend, precise, dia="pallas"):
    ref_coo, coo = MATRICES[matrix]()
    kw = dict(n=n) if matrix == "df32" else dict(n=n, min_head_cols=1, min_head_rows=1)
    ref_split, split = ref_hybrid.split_structure(ref_coo, **kw), tx.split_structure(coo, **kw)
    jax_backend, fmt, cfg = RESIDUE[backend]
    ref = ref_hybrid.HybridSpmmPlan(
        ref_split, n, residue_config=RefConfig(**cfg), residue_fmt=fmt, backend=jax_backend,
        dia_backend="pallas_interpret", precise=precise)
    ports = {level: tx.HybridSpmmPlan(split, n, residue_config=tx.SpmmConfig(**cfg),
                                      residue_fmt=fmt, backend=backend, dia_backend=dia,
                                      precise=level, device="cpu")
             for level in (0, precise)}
    return ref_coo, ref, ports


@pytest.mark.parametrize(
    "matrix,n,backend,precise",
    [
        ("df32", 16, "pallas", 1),  # K7 route
        ("df32", 16, "pallas", 2),
        ("df32", 40, "pallas", 1),  # K6 route
        ("mixed", 16, "pallas", 2),
        ("mixed", 40, "edge", 1),
        ("mixed", 24, "mxu", 1),
        ("mixed", 24, "ell_pallas", 1),
        ("stencil", 16, "pallas", 1),  # DIA only, no residue
        ("nonsquare", 40, "pallas", 2),
    ],
)
def test_hybrid_precise_matches_jax_plan(matrix, n, backend, precise):
    ref_coo, ref, ports = _hybrid_plans(matrix, n, backend, precise)
    port = ports[precise]
    split = port.split
    if matrix in ("df32", "mixed"):
        assert split.diag_offsets.size and split.head_cols.size and split.residue.nnz
    if matrix == "mixed":
        assert split.head_rows.size
    b = np.random.default_rng(n).standard_normal((ref_coo.shape[1], n)).astype(np.float32)
    c = np.random.default_rng(n + 1).standard_normal((ref_coo.shape[0], n)).astype(np.float32)
    with jax.enable_x64(backend == "ell_pallas"):  # the JAX ELL fold is f64 only so
        want = np.asarray(ref(b, ALPHA, BETA, c))
    got = port(b, ALPHA, BETA, c)
    assert got.device.type == "cpu" and got.shape == (ref_coo.shape[0], n)
    got = got.numpy()
    exact = golden_spmm_exact(RefCSR.from_coo(ref_coo), b, ALPHA, BETA, c)
    plain = ports[0](b, ALPHA, BETA, c).numpy()
    assert tx.verify(exact, got).passed
    _hub_rows_apart(got, want, split, _ulp(exact))
    assert _err(got, exact) <= _err(plain, exact)
    if matrix == "stencil":  # the DIA part alone, compensated: one rounding
        assert _err(got, exact) <= 1.0 * _ulp(exact)


@pytest.mark.parametrize("precise", [1, 2])
def test_hybrid_precise_repeat_and_no_c(precise):
    ref_coo, ref, ports = _hybrid_plans("mixed", 16, "pallas", precise)
    port = ports[precise]
    rng = np.random.default_rng(8)
    b = rng.standard_normal((600, 16)).astype(np.float32)
    c = rng.standard_normal((600, 16)).astype(np.float32)
    three = port(b, 0.5, 0.25, port(b, 0.5, 0.25, port(b, 0.5, 0.25, c)))
    chained = port.repeat(b, 0.5, 0.25, c, times=3)
    assert torch.equal(chained, three)
    want = np.asarray(ref.repeat(b, 0.5, 0.25, c, times=3))
    _hub_rows_apart(chained.numpy(), want, port.split, _ulp(want))
    # no C: beta * C is (0, 0)
    got = port(b, 1.5).numpy()
    exact = golden_spmm_exact(RefCSR.from_coo(ref_coo), b, 1.5, 0.0, None)
    _hub_rows_apart(got, np.asarray(ref(b, 1.5)), port.split, _ulp(exact))
    assert np.array_equal(port.repeat(b, 1.5, times=1).numpy(), got)


def test_hybrid_precise_xla_dia_is_compensated():
    """``dia_backend="xla"`` is the plain version of the DIA kernels, so in
    precise mode it is the compensated one (the JAX package's ``xla`` DIA
    part stays uncompensated f32): the same result as the kernels' route."""
    _, _, kernels = _hybrid_plans("stencil", 16, "pallas", 1, dia="pallas")
    _, _, plain = _hybrid_plans("stencil", 16, "pallas", 1, dia="xla")
    b = np.random.default_rng(3).standard_normal((500, 16)).astype(np.float32)
    c = np.random.default_rng(4).standard_normal((500, 16)).astype(np.float32)
    assert torch.equal(kernels[1](b, ALPHA, BETA, c), plain[1](b, ALPHA, BETA, c))
