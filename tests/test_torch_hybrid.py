"""The port's hybrid structure split against the JAX package's, on the CPU.

``split_structure`` is host NumPy code copied from ``sextans_tpu``: its
arrays must be identical, dtypes included. The plain version of the DIA
kernels (``spmm_dia_ref``, which the wrappers run on CPU tensors) is held to
the JAX kernels K6 ``spmm_dia_padded`` and K7 ``spmm_dia_ct_padded`` in
interpret mode, and ``HybridSpmmPlan(device="cpu")`` to the JAX
``HybridSpmmPlan`` with the ``pallas_interpret`` and ``xla`` DIA engines and
each residue engine. Tolerance: ``4 * spacing(f32(max|C_f64|))``, with both
passing ``verify`` against the f64 oracle: both sum the same f32 terms, the
port with one fused multiply-add per diagonal, the TPU kernels and XLA with
a product and a sum, and the head matmuls in another order.
"""

import numpy as np
import pytest
import torch

import sextans_tpu_torch as tx
from benchmarks import matrices as ref_matrices
from sextans_tpu.format.coo import COOMatrix as RefCOO
from sextans_tpu.format.csr import CSRMatrix as RefCSR
from sextans_tpu.ops import hybrid as ref_hybrid
from sextans_tpu.ops.golden import golden_spmm_exact
from sextans_tpu.ops.spmm_dia_pallas import spmm_dia_ct_padded, spmm_dia_padded
from sextans_tpu.utils.config import SpmmConfig as RefConfig
from sextans_tpu_torch.cli import main as cli_main
from sextans_tpu_torch.format.convert import from_reference
from sextans_tpu_torch.ops import hybrid
from sextans_tpu_torch.ops.launch import check_split
from sextans_tpu_torch.ops.spmm_dia import spmm_dia, spmm_dia_ref, spmm_dia_skinny
from sextans_tpu_torch.utils import matrices

ALPHA, BETA = 0.85, -2.06
SPLIT_ARRAYS = ("diag_offsets", "diag_vals", "head_cols", "head_dense", "head_rows",
                "head_rows_dense")


def _coo(m, k, rows, cols, vals=None, seed=0):
    """(m, k) COO from raw triplets, duplicates dropped; as both packages'."""
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    _, keep = np.unique(rows * k + cols, return_index=True)
    if vals is None:
        vals = np.random.default_rng(seed).standard_normal(keep.size).astype(np.float32)
        vals[vals == 0] = 1.0
    else:
        vals = np.asarray(vals, dtype=np.float32)[keep]
    rows, cols = rows[keep].astype(np.int32), cols[keep].astype(np.int32)
    return RefCOO((m, k), rows, cols, vals), tx.COOMatrix((m, k), rows, cols, vals)


def _stencil(m=500, offsets=(-7, -1, 0, 1, 7)):
    base = np.arange(m)
    rows = np.concatenate([base[(base + o >= 0) & (base + o < m)] for o in offsets])
    cols = np.concatenate([base[(base + o >= 0) & (base + o < m)] + o for o in offsets])
    return _coo(m, m, rows, cols)


def _powerlaw():
    rng = np.random.default_rng(3)
    m = 2000
    hub = rng.choice(m, 50, replace=False)
    rows = np.concatenate([rng.integers(0, m, 12000), rng.integers(0, m, 3000)])
    cols = np.concatenate([hub[rng.integers(0, 50, 12000)], rng.integers(0, m, 3000)])
    return _coo(m, m, rows, cols, seed=3)


def _mixed(m=600):
    """Two full diagonals, a hub column, two hub rows and a random residue.

    The hub rows hold 100 nonzeros each: a hub row's product is one f32 dot
    product as long as the row, and two summation orders of a few hundred
    terms (the port's and the JAX package's matmuls) drift apart by more
    than 4 ulp of max|C| (PERF.md, the hybrid slice)."""
    rng = np.random.default_rng(5)
    base = np.arange(m)
    rows = [base, base[:-3], rng.integers(0, m, 800), rng.integers(0, m, 3000),
            np.repeat([5, m // 2], 100)]
    cols = [base, base[:-3] + 3, rng.integers(0, m, 800), np.full(3000, 17),
            rng.integers(0, m, 200)]
    return _coo(m, m, np.concatenate(rows), np.concatenate(cols), seed=5)


def _nonsquare():
    base = np.arange(300)
    return _coo(300, 500, np.concatenate([base, base]),
                np.concatenate([base + 150, base + 10]), vals=np.ones(600))


def _hub_rows():
    rng = np.random.default_rng(11)
    m = 1500
    hub = rng.choice(m, 12, replace=False)
    rows = np.concatenate([np.repeat(hub, 400), rng.integers(0, m, 2000)])
    cols = rng.integers(0, m, rows.size)
    return _coo(m, m, rows, cols, seed=11)


def _circuit_band(m=4000):
    rng = np.random.default_rng(9)
    lr = rng.integers(0, m, m * 4)
    lc = np.clip(lr + rng.integers(-60, 61, m * 4), 0, m - 1)
    return _coo(m, m, np.concatenate([np.arange(m), lr]),
                np.concatenate([np.arange(m), lc]), seed=9)


MATRICES = {"stencil": _stencil, "powerlaw": _powerlaw, "mixed": _mixed,
            "nonsquare": _nonsquare, "hub_rows": _hub_rows,
            "circuit_band": _circuit_band}


def _assert_same_split(got, want):
    assert (got.m, got.k, got.nnz) == (want.m, want.k, want.nnz)
    for name in SPLIT_ARRAYS:
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert a.tobytes() == b.tobytes(), name
    assert tuple(got.residue.shape) == tuple(want.residue.shape)
    for name in ("rows", "cols", "vals"):
        a, b = getattr(got.residue, name), getattr(want.residue, name)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name


def _operands(m, k, n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((k, n)).astype(np.float32),
            rng.standard_normal((m, n)).astype(np.float32))


def _tol(exact):
    return 4 * np.spacing(np.float32(np.abs(exact).max()))


# ---- the host half: split_structure, its cost rules, persistence ----

@pytest.mark.parametrize("n", [None, 16, 512])
@pytest.mark.parametrize("matrix", list(MATRICES))
def test_split_matches_jax(matrix, n):
    ref_coo, coo = MATRICES[matrix]()
    want = ref_hybrid.split_structure(ref_coo, n=n)
    got = tx.split_structure(coo, n=n)
    _assert_same_split(got, want)
    assert got.summary() == want.summary()
    assert (got.diag_nnz + got.head_nnz + got.head_row_nnz + got.residue.nnz) == coo.nnz


@pytest.mark.parametrize(
    "matrix,kw",
    [
        ("powerlaw", dict(head_min_degree_frac=0.02, min_head_cols=8)),
        ("powerlaw", dict(n=512, max_head_cols=40, min_head_cols=4)),
        ("hub_rows", dict(min_head_rows=4, head_min_degree_frac=0.5)),
        ("hub_rows", dict(n=16, max_head_rows=5, min_head_rows=2)),
        ("mixed", dict(min_head_cols=1, min_head_rows=1, diag_min_density=0.5)),
        ("circuit_band", dict(max_diags=7, diag_min_density=0.01)),
    ],
)
def test_split_keywords_match_jax(matrix, kw):
    ref_coo, coo = MATRICES[matrix]()
    _assert_same_split(tx.split_structure(coo, **kw),
                       ref_hybrid.split_structure(ref_coo, **kw))


@pytest.mark.parametrize("m,n", [(4704, 16), (4704, 512), (170998, 512), (10**6, 40)])
def test_cost_rules_match_jax(m, n):
    assert hybrid.SPLIT_VERSION == ref_hybrid.SPLIT_VERSION
    assert hybrid._residue_edge_cycles(n) == ref_hybrid._residue_edge_cycles(n)
    assert hybrid._cost_based_diag(m, n) == ref_hybrid._cost_based_diag(m, n)
    for length in (m, 2 * m + 1):
        assert (hybrid._cost_based_degree(m, n, length)
                == ref_hybrid._cost_based_degree(m, n, length))


@pytest.mark.parametrize("saved_by", ["port", "jax"])
def test_split_save_load_across_packages(tmp_path, saved_by):
    ref_coo, coo = _mixed()
    want = ref_hybrid.split_structure(ref_coo, n=16, min_head_cols=1, min_head_rows=1)
    got = tx.split_structure(coo, n=16, min_head_cols=1, min_head_rows=1)
    path = tmp_path / "split.npz"
    (got if saved_by == "port" else want).save(path)
    _assert_same_split(hybrid.HybridSplit.load(path), want)
    _assert_same_split(ref_hybrid.HybridSplit.load(path), got)


def test_from_reference_carries_a_split():
    ref_coo, coo = _hub_rows()
    want = ref_hybrid.split_structure(ref_coo, n=16)
    got = from_reference(want)
    assert isinstance(got, tx.HybridSplit) and isinstance(got.residue, tx.COOMatrix)
    _assert_same_split(got, want)
    _assert_same_split(got, tx.split_structure(coo, n=16))


@pytest.mark.parametrize(
    "name,args",
    [("fem_like", (3000,)), ("circuit_like", (6000,)), ("stencil_3d", (12,)),
     ("circuit_like", (2000, 3, 7))],
)
def test_matrices_match_originals(name, args):
    want = getattr(ref_matrices, name)(*args, seed=4)
    got = getattr(matrices, name)(*args, seed=4)
    assert tuple(got.shape) == tuple(want.shape)
    for field in ("rows", "cols", "vals"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


# ---- the DIA kernels' plain version against K6 and K7 (interpret) ----

def _dia_operands(n):
    """The operands of tests/test_hybrid.py:230-284: offsets straddling
    64-row blocks and a negative one; dvals zero where i + off leaves A."""
    rng = np.random.default_rng(4)
    m = k = 160
    offsets = (-70, -1, 0, 3, 65)
    dvals = rng.standard_normal((len(offsets), m)).astype(np.float32)
    for j, off in enumerate(offsets):
        dvals[j, (np.arange(m) + off < 0) | (np.arange(m) + off >= k)] = 0.0
    b, c = _operands(m, k, n, seed=n)
    a = np.zeros((m, k))
    for j, off in enumerate(offsets):
        i = np.arange(max(0, -off), min(m, k - off))
        a[i, i + off] = dvals[j, i]
    return offsets, dvals, b, c, a


@pytest.mark.parametrize("with_c", [True, False])
@pytest.mark.parametrize("route,n", [("ct", 16), ("ct", 13), ("standard", 40)])
def test_dia_plain_matches_jax_kernels(route, n, with_c):
    import jax.numpy as jnp

    offsets, dvals, b, c, a = _dia_operands(n)
    m, tile_m, pad_lo = 160, 64, 70
    m_pad = 192
    beta = BETA if with_c else 0.0
    exact = ALPHA * (a @ b.astype(np.float64)) + (beta * c.astype(np.float64) if with_c else 0)
    dv_pad = np.zeros((len(offsets), m_pad), np.float32)
    dv_pad[:, :m] = dvals
    ab = (jnp.float32(ALPHA), jnp.float32(beta))
    if route == "ct":
        n_ct = -(-n // 8) * 8
        bt = jnp.pad(jnp.asarray(b.T), ((0, n_ct - n), (pad_lo, 0)))
        ct = jnp.pad(jnp.asarray(c.T), ((0, n_ct - n), (0, m_pad - m)))
        want = np.asarray(spmm_dia_ct_padded(
            jnp.asarray(dv_pad), bt, ct, *ab, offsets=offsets, tile_m=tile_m,
            interpret=True, with_c=with_c)).T[:m, :n]
    else:
        bp = jnp.pad(jnp.asarray(b), ((pad_lo, 0), (0, 128 - n)))
        cp = jnp.pad(jnp.asarray(c), ((0, m_pad - m), (0, 128 - n)))
        want = np.asarray(spmm_dia_padded(
            jnp.asarray(np.ascontiguousarray(dv_pad.T)), bp, cp, *ab, offsets=offsets,
            tile_m=tile_m, tile_n=128, interpret=True, with_c=with_c))[:m, :n]
    c_t = torch.from_numpy(c) if with_c else torch.zeros(1).expand(m, n)
    got = spmm_dia_ref(torch.from_numpy(dvals), torch.tensor(offsets, dtype=torch.int32),
                       torch.from_numpy(b), c_t, ALPHA, beta, with_c=with_c).numpy()
    assert got.shape == (m, n)
    assert np.abs(got - want).max() <= _tol(exact)
    assert np.abs(got - exact).max() <= _tol(exact)


def test_dia_wrappers_run_plain_version_on_cpu():
    offsets, dvals, b, c, _ = _dia_operands(24)
    args = (torch.from_numpy(dvals), torch.tensor(offsets, dtype=torch.int32),
            torch.from_numpy(b), torch.from_numpy(c), ALPHA, BETA)
    want = spmm_dia_ref(*args)
    before = (spmm_dia.launches, spmm_dia_skinny.launches)
    assert torch.equal(spmm_dia(*args), want) and torch.equal(spmm_dia_skinny(*args), want)
    assert (spmm_dia.launches, spmm_dia_skinny.launches) == before
    meta = torch.empty((2, 8), device="meta")
    for fn in (spmm_dia, spmm_dia_skinny):
        with pytest.raises(ValueError, match="cpu or cuda"):
            fn(meta, torch.empty(2, dtype=torch.int32, device="meta"), meta, meta, 1.0, 0.0)


def test_dia_plain_multiplies_stored_zeros_as_the_tpu_does():
    # a stored zero inside the band meets a non-finite B row: 0 * Inf is NaN
    # in both packages; rows of B outside [0, k) are zero padding in both
    offsets, dvals, b, c, _ = _dia_operands(16)
    dvals = dvals.copy()
    dvals[2, 40] = 0.0  # offset 0, row 40 reads B row 40
    b = b.copy()
    b[40] = np.inf
    got = spmm_dia_ref(torch.from_numpy(dvals), torch.tensor(offsets, dtype=torch.int32),
                       torch.from_numpy(b), torch.from_numpy(c), ALPHA, BETA).numpy()
    assert np.isnan(got[40]).all()
    bad = np.zeros(160, bool)
    for j, off in enumerate(offsets):  # rows whose diagonal j reads B row 40
        if 0 <= 40 - off < 160:
            bad[40 - off] = True
    assert np.isfinite(got[~bad]).all()


# ---- HybridSpmmPlan on the CPU against the JAX plan ----

RESIDUE = {  # port backend -> (JAX backend, residue format, config)
    "pallas": ("pallas_interpret", "vpu",
               dict(tile_m=64, window_k=128, block_k=8, group_blocks=16)),
    "xla": ("xla", "vpu", dict(tile_m=64, window_k=128, block_k=8, group_blocks=16)),
    "mxu": ("mxu_interpret", "mxu",
            dict(tile_m=128, window_k=128, block_k=16, group_blocks=4)),
    "edge": ("edge_interpret", "edge",
             dict(tile_m=64, window_k=128, edge_chunk=64, edge_lanes=2)),
    "ell_pallas": ("ell_pallas_interpret", "ell", dict(tile_m=64, ell_r=4)),
    "ell": ("ell", "ell", dict(tile_m=64, ell_r=4)),
}


def _splits(matrix, n):
    ref_coo, coo = MATRICES[matrix]()
    kw = dict(n=n, min_head_cols=1, min_head_rows=1)
    return ref_coo, ref_hybrid.split_structure(ref_coo, **kw), tx.split_structure(coo, **kw)


def _plans(matrix, n, backend, dia):
    ref_coo, ref_split, split = _splits(matrix, n)
    jax_backend, fmt, cfg = RESIDUE[backend]
    ref = ref_hybrid.HybridSpmmPlan(
        ref_split, n, residue_config=RefConfig(**cfg), residue_fmt=fmt,
        backend=jax_backend, dia_backend="pallas_interpret" if dia == "pallas" else dia)
    port = tx.HybridSpmmPlan(split, n, residue_config=tx.SpmmConfig(**cfg),
                             residue_fmt=fmt, backend=backend, dia_backend=dia,
                             device="cpu")
    return ref_coo, ref, port


@pytest.mark.parametrize(
    "matrix,n,backend,dia",
    [
        ("mixed", 16, "pallas", "pallas"),  # K7 route
        ("mixed", 40, "pallas", "pallas"),  # K6 route
        ("mixed", 40, "xla", "xla"),
        ("mixed", 40, "mxu", "xla"),
        ("mixed", 16, "edge", "pallas"),
        ("mixed", 24, "ell_pallas", "xla"),
        ("mixed", 40, "ell", "pallas"),
        ("stencil", 16, "pallas", "pallas"),  # empty residue
        ("stencil", 40, "pallas", "xla"),
        ("nonsquare", 16, "pallas", "pallas"),
    ],
)
def test_hybrid_plan_matches_jax(matrix, n, backend, dia):
    ref_coo, ref, port = _plans(matrix, n, backend, dia)
    split = port.split
    assert (port.residue_plan is None) == (split.residue.nnz == 0)
    assert port.nbytes >= (split.diag_vals.nbytes + split.head_dense.nbytes
                           + split.head_rows_dense.nbytes)
    if matrix == "mixed":
        assert split.diag_offsets.size and split.head_cols.size and split.head_rows.size
        assert split.residue.nnz > 0
    b, c = _operands(*ref_coo.shape, n, seed=n)
    want = np.asarray(ref(b, ALPHA, BETA, c))
    got = port(b, ALPHA, BETA, c)
    assert got.device.type == "cpu" and got.shape == (ref_coo.shape[0], n)
    got = got.numpy()
    exact = golden_spmm_exact(RefCSR.from_coo(ref_coo), b, ALPHA, BETA, c)
    assert tx.verify(exact, got).passed and tx.verify(exact, want).passed
    assert np.abs(got - want).max() <= _tol(exact)
    assert np.abs(got - exact).max() <= _tol(exact)


@pytest.mark.parametrize("n", [16, 40])
def test_hybrid_no_c_path(n):
    ref_coo, ref, port = _plans("mixed", n, "xla", "xla")
    b, _ = _operands(*ref_coo.shape, n, seed=3)
    got = port(b, 1.5).numpy()
    want = np.asarray(ref(b, 1.5, 0.0, None))
    exact = golden_spmm_exact(RefCSR.from_coo(ref_coo), b, 1.5, 0.0, None)
    assert tx.verify(exact, got).passed
    assert np.abs(got - want).max() <= _tol(exact)
    assert np.abs(got - exact).max() <= _tol(exact)
    assert np.array_equal(port.repeat(b, 1.5, times=1).numpy(), got)


@pytest.mark.parametrize("n", [16, 40])
def test_hybrid_repeat_chains_like_calls(n):
    ref_coo, ref, port = _plans("mixed", n, "pallas", "pallas")
    b, c = _operands(*ref_coo.shape, n, seed=8)
    step = port(b, 0.5, 0.25, c)
    two = port(b, 0.5, 0.25, step)
    chained = port.repeat(b, 0.5, 0.25, c, times=2)
    assert torch.equal(chained, two)
    want = np.asarray(ref.repeat(b, 0.5, 0.25, c, times=2))
    assert np.abs(chained.numpy() - want).max() <= _tol(want)


def test_hybrid_dia_routes():
    _, _, split16 = _splits("stencil", 16)
    assert tx.HybridSpmmPlan(split16, 16, device="cpu")._dia is spmm_dia_ref
    assert (tx.HybridSpmmPlan(split16, 16, dia_backend="pallas", device="cpu")._dia
            is spmm_dia_skinny)
    assert (tx.HybridSpmmPlan(split16, 33, dia_backend="pallas", device="cpu")._dia
            is spmm_dia)


# ---- errors ----

def _mixed_split(n=16):
    return _splits("mixed", n)[2]


def test_hybrid_plan_rejects_bad_operands():
    pl = tx.HybridSpmmPlan(_mixed_split(), 16, residue_config=tx.SpmmConfig(),
                           residue_fmt="vpu", device="cpu")
    b, c = _operands(600, 600, 16)
    with pytest.raises(ValueError, match="B must be"):
        pl(b[:, :8], ALPHA, BETA, c)
    with pytest.raises(ValueError, match="C must be"):
        pl(b, ALPHA, BETA, c[:-1])
    with pytest.raises(ValueError, match="beta != 0 requires an input C"):
        pl(b, ALPHA, BETA)
    with pytest.raises(ValueError, match="beta != 0 requires an input C"):
        pl.repeat(b, ALPHA, BETA, times=2)


@pytest.mark.parametrize(
    "kw,err,match",
    [
        (dict(precise=1), ValueError, "choose_backend"),
        (dict(precise=3, residue_fmt="vpu"), ValueError, "precise must be"),
        (dict(), ValueError, "choose_backend"),
        # a residue without its config: the JAX package takes choose_backend's
        (dict(residue_fmt="vpu"), ValueError, "residue_config.*choose_backend"),
        (dict(backend="pallas"), ValueError, "residue_config.*choose_backend"),
        (dict(residue_fmt="csr"), ValueError, "residue_fmt"),
        (dict(backend="tpu"), ValueError, "unknown backend"),
        (dict(residue_fmt="vpu", dia_backend="pallas_interpret"), ValueError, "dia_backend"),
        (dict(residue_fmt="mxu", backend="edge", residue_config=tx.SpmmConfig()), ValueError,
         "does not match"),
    ],
)
def test_hybrid_plan_rejects_bad_options(kw, err, match):
    with pytest.raises(err, match=match):
        tx.HybridSpmmPlan(_mixed_split(), 16, device="cpu", **kw)


@pytest.mark.parametrize("precise,fmt", [(2, "vpu"), (1, "ell")])
def test_hybrid_precise_plan_builds(precise, fmt):
    """A precise plan packs its residue at its own level and runs; the
    precise composition is tested in tests/test_torch_precise_hybrid.py."""
    pl = tx.HybridSpmmPlan(_mixed_split(), 16, residue_config=tx.SpmmConfig(),
                           residue_fmt=fmt, precise=precise, device="cpu")
    assert pl.precise == precise
    assert pl.residue_plan.packed.config.precise == precise
    b, c = _operands(600, 600, 16)
    got = pl(b, ALPHA, BETA, c).numpy()
    ref_coo = _mixed()[0]
    exact = golden_spmm_exact(RefCSR.from_coo(ref_coo), b, ALPHA, BETA, c)
    assert tx.verify(exact, got).passed
    assert np.abs(got - exact).max() <= _tol(exact)


def test_empty_residue_needs_no_backend_and_backend_picks_format():
    _, _, split = _splits("stencil", 16)
    assert split.residue.nnz == 0
    assert tx.HybridSpmmPlan(split, 16, device="cpu").residue_plan is None
    pl = tx.HybridSpmmPlan(_mixed_split(), 16, residue_config=tx.SpmmConfig(),
                           backend="edge", device="cpu")
    assert isinstance(pl.residue_plan.packed, tx.PackedSpMatrixEdge)


@pytest.mark.parametrize(
    "field,value,match",
    [
        ("diag_offsets", lambda s: s.diag_offsets[::-1].copy(), "ascend"),
        ("diag_offsets", lambda s: s.diag_offsets + 1000, "ascend"),
        ("head_cols", lambda s: s.head_cols + 600, "head_cols"),
        ("head_rows", lambda s: np.repeat(s.head_rows[:1], s.head_rows.size), "head_rows"),
        ("diag_vals", lambda s: s.diag_vals[:, 1:], "diag_vals"),
        ("head_rows_dense", lambda s: s.head_rows_dense.T, "head_rows_dense"),
    ],
)
def test_split_checked_before_upload(field, value, match):
    split = _mixed_split()
    setattr(split, field, value(split))
    with pytest.raises(ValueError, match=match):
        check_split(split)
    with pytest.raises(ValueError, match=match):
        tx.HybridSpmmPlan(split, 16, residue_config=tx.SpmmConfig(), residue_fmt="vpu",
                          device="cpu")


# ---- the CLI ----

@pytest.mark.parametrize("n,backend", [("16", "pallas"), ("40", "edge")])
def test_cli_hybrid_prints_success(tmp_path, capsys, n, backend):
    path = tmp_path / "mixed.mtx"
    tx.write_mtx(path, _mixed()[1])
    rc = cli_main([str(path), n, "2", "--hybrid", "--backend", backend, "--device", "cpu",
                   "--tile-m", "64", "--window-k", "128"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "HybridSplit(m=600" in out and "Success!" in out
    assert "Kernel time is" in out and "GFLOPS:" in out


@pytest.mark.parametrize("precise", [0, 1])
def test_plain_contractions_leave_the_callers_tf32_switches(precise):
    """The plain versions contract in full f32 (``ops/launch.py:no_tf32``)
    and hand both TF32 switches back as the caller set them: the block and
    slab plain versions and a hybrid step with head columns and rows."""
    _, port = _mixed()
    split = tx.split_structure(port, n=16, min_head_cols=1, min_head_rows=1)
    assert split.head_cols.size and split.head_rows.size and split.residue.nnz
    cfg = tx.SpmmConfig(tile_m=128, window_k=128, block_k=8, group_blocks=16)
    plans = [tx.HybridSpmmPlan(split, 16, residue_config=cfg, backend="pallas",
                               precise=precise, device="cpu"),
             tx.SpmmPlan(tx.pack(port, cfg), 16, "xla", device="cpu"),
             tx.SpmmPlan(tx.pack_mxu(port, cfg.with_(precise=precise)), 16, "mxu",
                         device="cpu")]
    b = np.random.default_rng(0).standard_normal((port.shape[1], 16)).astype(np.float32)
    switches = (torch.backends.cuda.matmul, torch.backends.cudnn)
    saved = [s.allow_tf32 for s in switches]
    try:
        for s in switches:
            s.allow_tf32 = False
        want = [pl(b, ALPHA) for pl in plans]
        for s in switches:
            s.allow_tf32 = True
        got = [pl(b, ALPHA) for pl in plans]
        assert all(s.allow_tf32 is True for s in switches)
    finally:
        for s, v in zip(switches, saved):
            s.allow_tf32 = v
    assert all(torch.equal(g, w) for g, w in zip(got, want))
