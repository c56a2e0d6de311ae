"""The port's main path end to end on the CPU, against the JAX package.

read_mtx -> pack / pack_mxu -> plan(device="cpu") -> result, held against
``sextans_tpu.spmm`` on its ``xla``, ``pallas_interpret`` and
``mxu_interpret`` backends (same file, same B, C, alpha, beta) with the
tolerance ``4 * spacing(f32(max|C_f64|))`` (f32 sums in another
association), and against the f64 oracle through ``verify``. Then the plan's
no-C path, permutations, repeat and errors, the API surface and the CLI.
"""

import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import sextans_tpu as sx
import sextans_tpu_torch as tx
from sextans_tpu_torch.cli import main as cli_main
from sextans_tpu_torch.utils.timing import time_repeat

ALPHA, BETA = 0.85, -2.06

BLOCK_CFG = dict(tile_m=64, window_k=128, block_k=8, group_blocks=16)
SLAB_CFG = dict(tile_m=128, window_k=128, block_k=16, group_blocks=4)
EDGE_CFG = dict(tile_m=64, window_k=128, edge_chunk=64, edge_lanes=2)
ELL_CFG = dict(tile_m=64)
ELL_R = 4  # slots per row: the JAX interpreter's time grows with it


@pytest.fixture(scope="module")
def mtx_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("slice") / "a.mtx"
    tx.write_mtx(path, tx.COOMatrix.random(230, 190, 1800, seed=21, banded=True,
                                           bandwidth=40))
    return path


def _operands(m, k, n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((k, n)).astype(np.float32),
            rng.standard_normal((m, n)).astype(np.float32))


def _tol(exact):
    return 4 * np.spacing(np.float32(np.abs(exact).max()))


def _pack(coo, backend, **kw):
    if backend == "mxu":
        return tx.pack_mxu(coo, tx.SpmmConfig(**SLAB_CFG), **kw)
    if backend == "edge":
        return tx.pack_edge(coo, tx.SpmmConfig(**EDGE_CFG), **kw)
    if backend in ("ell", "ell_pallas"):
        return tx.pack_ell(coo, tx.SpmmConfig(**ELL_CFG), slots_per_row=ELL_R, **kw)
    return tx.pack(coo, tx.SpmmConfig(**BLOCK_CFG), **kw)


def _ref_pack(ref_coo, backend, **kw):
    if backend == "mxu":
        return sx.pack_mxu(ref_coo, sx.SpmmConfig(**SLAB_CFG), impl="numpy", **kw)
    if backend == "edge":
        return sx.pack_edge(ref_coo, sx.SpmmConfig(**EDGE_CFG), impl="numpy", **kw)
    if backend in ("ell", "ell_pallas"):
        return sx.pack_ell(ref_coo, sx.SpmmConfig(**ELL_CFG), slots_per_row=ELL_R, **kw)
    return sx.pack(ref_coo, sx.SpmmConfig(**BLOCK_CFG), impl="numpy", **kw)


@pytest.mark.parametrize(
    "backend,jax_backend,n",
    [
        ("pallas", "pallas_interpret", 24),
        ("xla", "xla", 24),
        ("pallas", "xla", 8),
        ("mxu", "mxu_interpret", 40),
        ("mxu", "mxu_interpret", 16),
        ("edge", "edge_interpret", 24),
        ("ell", "ell", 13),
        ("ell_pallas", "ell_pallas_interpret", 24),
    ],
)
def test_main_path_matches_jax(mtx_file, backend, jax_backend, n):
    coo = tx.read_mtx(mtx_file)
    m, k = coo.shape
    b, c = _operands(m, k, n)
    got = tx.plan(_pack(coo, backend), n, backend, device="cpu")(b, ALPHA, BETA, c)
    assert isinstance(got, torch.Tensor) and got.shape == (m, n)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    got = got.numpy()

    ref_coo = sx.read_mtx(mtx_file)
    ref_packed = _ref_pack(ref_coo, backend)
    want = np.asarray(sx.spmm(ref_packed, b, ALPHA, BETA, c, backend=jax_backend))
    exact = sx.golden_spmm_exact(sx.CSRMatrix.from_coo(ref_coo), b, ALPHA, BETA, c)
    assert tx.verify(exact, got).passed and tx.verify(exact, want).passed
    assert np.abs(got - want).max() <= _tol(exact)


@pytest.mark.parametrize("backend", ["pallas", "mxu", "xla", "edge", "ell", "ell_pallas"])
def test_no_c_path(mtx_file, backend):
    coo = tx.read_mtx(mtx_file)
    b, _ = _operands(*coo.shape, 40)
    got = tx.plan(_pack(coo, backend), 40, backend, device="cpu")(b, 1.5).numpy()
    exact = tx.golden_spmm_exact(tx.CSRMatrix.from_coo(coo), b, 1.5)
    assert tx.verify(exact, got).passed
    assert np.abs(got - exact).max() <= _tol(exact)


@pytest.mark.parametrize("backend", ["pallas", "mxu", "edge"])
def test_col_and_row_permutations(mtx_file, backend):
    coo = tx.read_mtx(mtx_file)
    b, c = _operands(*coo.shape, 24, seed=3)
    exact = tx.golden_spmm_exact(tx.CSRMatrix.from_coo(coo), b, ALPHA, BETA, c)
    for kw in (dict(reorder_cols=True), dict(reorder_rows_=True),
               dict(reorder_cols=True, reorder_rows_=True)):
        packed = _pack(coo, backend, **kw)
        got = tx.plan(packed, 24, backend, device="cpu")(b, ALPHA, BETA, c).numpy()
        assert np.abs(got - exact).max() <= _tol(exact), kw


@pytest.mark.parametrize("backend,jax_backend", [("pallas", "xla"),
                                                 ("mxu", "mxu_interpret")])
def test_repeat_feeds_c_back(mtx_file, backend, jax_backend):
    coo = tx.read_mtx(mtx_file)
    b, c = _operands(*coo.shape, 16, seed=4)
    pl = tx.plan(_pack(coo, backend, reorder_rows_=True), 16, backend, device="cpu")
    got = pl.repeat(b, ALPHA, BETA, c, times=3).numpy()
    step = c
    for _ in range(3):
        step = pl(b, ALPHA, BETA, step).numpy()
    assert np.abs(got - step).max() <= _tol(step)
    ref_coo = sx.read_mtx(mtx_file)
    cfg = sx.SpmmConfig(**(SLAB_CFG if backend == "mxu" else BLOCK_CFG))
    ref_packed = (sx.pack_mxu(ref_coo, cfg, impl="numpy", reorder_rows_=True)
                  if backend == "mxu"
                  else sx.pack(ref_coo, cfg, impl="numpy", reorder_rows_=True))
    want = np.asarray(sx.SpmmPlan(ref_packed, 16, backend=jax_backend)
                      .repeat(b, ALPHA, BETA, c, times=3))
    assert np.abs(got - want).max() <= _tol(want)
    # beta == 0 with no C starts the chain from zeros
    z = pl.repeat(b, 1.0, 0.0, None, times=1).numpy()
    assert np.abs(z - pl(b, 1.0).numpy()).max() <= _tol(z)


def test_plan_errors(mtx_file):
    coo = tx.read_mtx(mtx_file)
    m, k = coo.shape
    packed = _pack(coo, "pallas")
    pl = tx.plan(packed, 8, device="cpu")
    b, c = _operands(m, k, 8)
    with pytest.raises(ValueError, match="B must be"):
        pl(b[:, :7])
    with pytest.raises(ValueError, match="B must be"):
        pl.repeat(b[1:], times=2)
    with pytest.raises(ValueError, match="C must be"):
        pl(b, 1.0, 1.0, c[1:])
    with pytest.raises(ValueError, match="requires an input C"):
        pl(b, 1.0, 0.5)
    with pytest.raises(ValueError, match="requires an input C"):
        pl.repeat(b, 1.0, 0.5, times=2)
    with pytest.raises(ValueError, match="does not match"):
        tx.SpmmPlan(packed, 8, "mxu", device="cpu")
    with pytest.raises(ValueError, match="does not match"):
        tx.SpmmPlan(_pack(coo, "mxu"), 8, "pallas", device="cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        tx.SpmmPlan(packed, 8, "edge_interpret", device="cpu")
    with pytest.raises(ValueError, match="does not match"):
        tx.SpmmPlan(packed, 8, "edge", device="cpu")
    with pytest.raises(ValueError, match="does not match"):
        tx.SpmmPlan(_pack(coo, "ell"), 8, "pallas", device="cpu")
    with pytest.raises(TypeError, match="PackedSpMatrix"):
        tx.SpmmPlan(coo, 8, device="cpu")
    with pytest.raises(ValueError, match="positive"):
        tx.SpmmPlan(packed, 0, device="cpu")


def test_plan_checks_pack_steering(mtx_file):
    coo = tx.read_mtx(mtx_file)
    for field, value, match in (("bcol", 1 << 20, "bcol"),
                                ("group_kwin", 99, "K-window"),
                                ("qrow", 999, "row index")):
        packed = _pack(coo, "pallas")
        arr = getattr(packed, field).copy()
        arr.flat[0] = value
        setattr(packed, field, arr)
        with pytest.raises(ValueError, match=match):
            tx.SpmmPlan(packed, 8, device="cpu")


def test_upload_and_plans_are_cached(mtx_file):
    packed = _pack(tx.read_mtx(mtx_file), "mxu")
    p1 = tx.plan(packed, 16, "mxu", device="cpu")
    assert tx.plan(packed, 16, "mxu", device=torch.device("cpu")) is p1
    p2 = tx.plan(packed, 48, "mxu", device="cpu")
    assert p2 is not p1 and p2.arrays[0] is p1.arrays[0]


def test_spmm_and_prepare_inputs(mtx_file):
    coo = tx.read_mtx(mtx_file)
    m, k = coo.shape
    b, c = _operands(m, k, 12)
    exact = tx.golden_spmm_exact(tx.CSRMatrix.from_coo(coo), b, ALPHA, BETA, c)
    dense = coo.to_dense()
    for a in (coo, tx.CSRMatrix.from_coo(coo), tx.CSCMatrix.from_coo(coo),
              coo.to_scipy().tocsr(), sp.csc_array(coo.to_scipy()), dense,
              torch.from_numpy(dense)):
        got = tx.spmm(a, b, ALPHA, BETA, c, config=tx.SpmmConfig(**BLOCK_CFG),
                      device="cpu")
        assert np.abs(got.numpy() - exact).max() <= _tol(exact), type(a)
    got = tx.spmm(coo, torch.from_numpy(b), ALPHA, BETA, torch.from_numpy(c),
                  backend="xla")
    assert got.device.type == "cpu" and tx.verify(exact, got.numpy()).passed
    with pytest.raises(TypeError, match="unsupported"):
        tx.prepare("not a matrix")
    with pytest.raises(ValueError, match="B must be"):
        tx.spmm(coo, b[:5])


def test_prepare_passes_every_pack_through(mtx_file):
    coo = tx.read_mtx(mtx_file)
    b, c = _operands(*coo.shape, 8)
    exact = tx.golden_spmm_exact(tx.CSRMatrix.from_coo(coo), b, ALPHA, BETA, c)
    for backend in ("pallas", "mxu", "edge", "ell"):
        packed = _pack(coo, backend)
        assert tx.prepare(packed) is packed
        got = tx.spmm(packed, b, ALPHA, BETA, c, device="cpu").numpy()
        assert np.abs(got - exact).max() <= _tol(exact), backend
    auto = {"pallas": "pallas", "mxu": "mxu", "edge": "edge", "ell": "ell_pallas"}
    for backend, picked in auto.items():
        assert tx.SpmmPlan(_pack(coo, backend), 8, device="cpu").backend == picked


def test_spmm_defaults_to_cuda(mtx_file, monkeypatch):
    packed = _pack(tx.read_mtx(mtx_file), "edge")
    b = np.ones((packed.k, 8), np.float32)
    if not torch.cuda.is_available():
        # no card: the call raises instead of running on the CPU
        with pytest.raises((RuntimeError, AssertionError)):
            tx.spmm(packed, b)
    seen = []

    def fake_plan(packed, n, backend="auto", *, device):
        seen.append(torch.device(device).type)
        return lambda b, alpha, beta, c: torch.zeros(1)

    monkeypatch.setattr("sextans_tpu_torch.ops.spmm.plan", fake_plan)
    tx.spmm(packed, b)
    tx.spmm(packed, torch.from_numpy(b))
    tx.spmm(packed, b, device="cpu")
    assert seen == ["cuda", "cpu", "cpu"]


def test_time_repeat_on_cpu_reports_cpu(mtx_file):
    pl = tx.plan(_pack(tx.read_mtx(mtx_file), "pallas"), 8, device="cpu")
    b, c = _operands(pl.m, pl.k, 8)
    dt, info = time_repeat(pl, b, ALPHA, BETA, c, times=2, detail=True)
    assert dt > 0 and info["device"] == "cpu"
    assert info["method"] in ("differential", "amortized")


def test_exports_mirror_jax_package():
    for name in tx.__all__:
        assert getattr(tx, name) is not None, name
        if name != "from_reference":
            assert name in sx.__all__, name
    assert {f.name for f in dataclasses.fields(tx.SpmmConfig)} == \
        {f.name for f in dataclasses.fields(sx.SpmmConfig)}


@pytest.mark.parametrize("backend", ["pallas", "mxu", "xla", "edge", "ell", "ell_pallas"])
def test_cli_prints_success(mtx_file, backend, capsys):
    rc = cli_main([str(mtx_file), "13", "2", "--backend", backend,
                   "--device", "cpu", "--tile-m", "128", "--window-k", "128",
                   "--group-blocks", "16"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "N = 16" in out and "Success!" in out
    assert "Kernel time is" in out and "GFLOPS:" in out


def test_cli_rejects_options_not_ported(mtx_file, capsys):
    with pytest.raises(SystemExit):
        cli_main([str(mtx_file), "8", "--autotune", "--device", "cpu"])
    capsys.readouterr()
    # precise runs on every backend, the ELL engine's included
    rc = cli_main([str(mtx_file), "8", "--precise", "--backend", "ell_pallas",
                   "--device", "cpu"])
    captured = capsys.readouterr()
    assert rc == 0 and "Success!" in captured.out, captured.out
    assert "ROADMAP.md" not in captured.err


@pytest.mark.parametrize("backend", ["pallas", "mxu", "edge", "ell"])
def test_cli_save_packed_writes_the_jax_packages_file(mtx_file, tmp_path, backend, capsys):
    path = tmp_path / "a.npz"
    rc = cli_main([str(mtx_file), "13", "--backend", backend, "--device", "cpu",
                   "--tile-m", "128", "--window-k", "128", "--group-blocks", "16",
                   "--save-packed", str(path)])
    out = capsys.readouterr().out
    assert rc == 0 and "Success!" in out and f"packed A saved to {path}" in out, out
    kind = tx.ops.plan.BACKEND_FORMATS[backend][1]
    port, ref = kind.load(path), getattr(sx, kind.__name__).load(path)
    for name in ("vals", "group_kwin" if backend in ("pallas", "mxu") else
                 "meta" if backend == "edge" else "cols"):
        assert getattr(port, name).tobytes() == getattr(ref, name).tobytes(), name
    coo = tx.read_mtx(mtx_file)
    b, c = _operands(*coo.shape, 16)
    got = tx.plan(port, 16, backend, device="cpu")(b, 0.85, -2.06, c).numpy()
    assert tx.verify(tx.golden_spmm_exact(tx.CSRMatrix.from_coo(coo), b, 0.85, -2.06, c),
                     got).passed


@pytest.mark.parametrize("flags", [["--reorder-cols"], ["--reorder-rows"],
                                   ["--reorder-cols", "--reorder-rows"]])
@pytest.mark.parametrize("backend", ["auto", "mxu", "edge"])
def test_cli_reorders_before_packing(mtx_file, tmp_path, backend, flags, capsys):
    path = tmp_path / "a.npz"
    args = [str(mtx_file), "13", "--device", "cpu", "--tile-m", "128", "--window-k", "128",
            "--group-blocks", "16", *flags, "--save-packed", str(path)]
    rc = cli_main(args if backend == "auto" else [*args, "--backend", backend])
    out = capsys.readouterr().out
    assert rc == 0 and "Success!" in out, out
    packed = (tx.PackedSpMatrixEdge if backend == "edge" else tx.PackedSpMatrixMXU
              if backend == "mxu" else tx.PackedSpMatrix).load(path)
    assert (packed.col_perm is not None) == ("--reorder-cols" in flags)
    assert (packed.row_perm is not None) == ("--reorder-rows" in flags)


def test_cli_defaults_to_auto_and_skips_the_cpu_run(mtx_file, capsys):
    assert tx.cli.build_parser().parse_args([str(mtx_file), "8"]).backend == "auto"
    rc = cli_main([str(mtx_file), "13", "--device", "cpu", "--skip-cpu"])
    out = capsys.readouterr().out
    assert rc == 0 and "Kernel time is" in out, out
    assert "Run spmm on cpu" not in out and "Success!" not in out
    rc = cli_main([str(mtx_file), "13", "--device", "cpu", "--hybrid", "--tile-m", "64"])
    out = capsys.readouterr().out
    assert rc == 0 and "Success!" in out, out  # auto: the residue on the block format
    for backend in ("ell", "ell_pallas"):
        with pytest.raises(SystemExit, match="permutation-invariant"):
            cli_main([str(mtx_file), "8", "--device", "cpu", "--backend", backend,
                      "--reorder-rows"])
