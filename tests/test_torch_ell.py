"""The port's ELL gather engines against the JAX package's, on the CPU.

The same ELL pack (packed by ``sextans_tpu`` and carried over with
``from_reference``), B, C, alpha = 0.85 and beta = -2.06 go through:

* the port's ``ell`` backend (``spmm_ell_padded_ref``) and the JAX
  package's ``ell`` (``spmm_ell_xla.spmm_ell_padded``);
* the port's ``ell_pallas`` backend (on CPU tensors, the plain version
  ``spmm_ell_gather_padded_ref``) and the JAX package's
  ``ell_pallas_interpret`` (the Pallas kernel K5 in interpret mode).

Tolerance: ``max|port - jax| <= 4 * spacing(f32(max|C_f64|))``, with both
passing ``verify`` against the f64 oracle: both sides sum the same f32
products in slot order and fold the hub rows in order.
"""

import torch_cpu  # noqa: F401  one torch thread per xdist worker

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
from sextans_tpu_torch.ops.spmm_ell import (
    check_ell_pack,
    spmm_ell_gather_padded,
    spmm_ell_gather_padded_ref,
    spmm_ell_padded_ref,
)

ALPHA, BETA = 0.85, -2.06
JAX_BACKEND = {"ell": "ell", "ell_pallas": "ell_pallas_interpret"}


def _hub_rows():
    # row 7 holds 60 nonzeros: at R = 4 it spills into 14 virtual rows
    rng = np.random.default_rng(3)
    rows = np.concatenate([np.full(60, 7), rng.integers(0, 100, 200)])
    cols = np.concatenate([rng.choice(140, 60, replace=False),
                           rng.integers(0, 140, 200)])
    vals = rng.standard_normal(rows.size).astype(np.float32)
    return RefCOO((100, 140), rows, cols, vals)


MATRICES = {
    "random": lambda: RefCOO.random(120, 150, 400, seed=1),
    "hub_rows": _hub_rows,
}


def _operands(m, k, n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((k, n)).astype(np.float32),
            rng.standard_normal((m, n)).astype(np.float32))


def _tol(x):
    return 4 * np.spacing(np.float32(np.abs(x).max()))


def _packs(coo, r=None, tile_m=32):
    ref = ref_pack_ell(coo, RefConfig(tile_m=tile_m), slots_per_row=r)
    return ref, from_reference(ref)


@pytest.mark.parametrize("backend", ["ell", "ell_pallas"])
@pytest.mark.parametrize(
    "matrix,r,n,with_c",
    [
        ("random", None, 24, True),
        ("random", None, 13, False),
        ("hub_rows", 4, 16, True),
        ("hub_rows", 4, 13, True),
        ("hub_rows", 4, 24, False),
    ],
)
def test_ell_matches_jax(backend, matrix, r, n, with_c):
    coo = MATRICES[matrix]()
    ref, port = _packs(coo, r)
    if matrix == "hub_rows":
        assert port.n_virt > 0
    b, c = _operands(*coo.shape, n)
    beta, cin = (BETA, c) if with_c else (0.0, None)
    want = np.asarray(RefPlan(ref, n, backend=JAX_BACKEND[backend])(b, ALPHA, beta, cin))
    got = tx.plan(port, n, backend, device="cpu")(b, ALPHA, beta, cin)
    assert got.device.type == "cpu" and got.shape == (coo.shape[0], n)
    got = got.numpy()
    exact = golden_spmm_exact(RefCSR.from_coo(coo), b, ALPHA, beta, cin)
    assert tx.verify(exact, got).passed and tx.verify(exact, want).passed
    assert np.abs(got - want).max() <= _tol(exact)
    assert np.abs(got - exact).max() <= _tol(exact)


@pytest.mark.parametrize("backend", ["ell", "ell_pallas"])
def test_ell_repeat_with_hub_rows_matches_jax(backend):
    # the carry holds the virtual rows of the previous call: the fold must
    # strip their beta * C term (ell_pallas) or never see it (ell)
    coo = MATRICES["hub_rows"]()
    ref, port = _packs(coo, 4)
    b, c = _operands(*coo.shape, 16, seed=4)
    want = np.asarray(RefPlan(ref, 16, backend=JAX_BACKEND[backend])
                      .repeat(b, ALPHA, BETA, c, times=3))
    pl = tx.plan(port, 16, backend, device="cpu")
    got = pl.repeat(b, ALPHA, BETA, c, times=3).numpy()
    assert np.abs(got - want).max() <= _tol(want)
    exact = c
    for _ in range(3):
        exact = golden_spmm_exact(RefCSR.from_coo(coo), b, ALPHA, BETA, exact)
    assert tx.verify(exact, got).passed
    assert np.abs(got - exact).max() <= 2 * _tol(exact)


def test_ell_pallas_selects_out_pads_with_nonfinite_b():
    coo = RefCOO.random(64, 96, 200, seed=6)
    ref, port = _packs(coo, 4)
    b, _ = _operands(64, 96, 16, seed=7)
    b[0] = np.nan  # the column of every pad slot
    b[50] = np.inf
    want = np.asarray(RefPlan(ref, 16, backend="ell_pallas_interpret")(b, 1.0, 0.0))
    got = tx.plan(port, 16, "ell_pallas", device="cpu")(b, 1.0, 0.0).numpy()
    clean = np.ones(64, bool)
    clean[coo.rows[np.isin(coo.cols, (0, 50))]] = False
    assert clean.sum() > 32
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    assert np.isfinite(got[clean]).all()
    exact = golden_spmm_exact(RefCSR.from_coo(coo), b, 1.0, 0.0, None)
    assert np.abs(got[clean] - exact[clean]).max() <= _tol(exact[clean])
    # the plain engine multiplies its pads, as the JAX package's does
    plain = tx.plan(port, 16, "ell", device="cpu")(b, 1.0, 0.0).numpy()
    assert not np.isfinite(plain).all()


@pytest.mark.parametrize("backend", ["ell", "ell_pallas"])
def test_ell_empty_matrix(backend):
    empty = RefCOO((40, 30), np.empty(0, np.int64), np.empty(0, np.int64),
                   np.empty(0, np.float32))
    ref, port = _packs(empty)
    b, c = _operands(40, 30, 8)
    got = tx.plan(port, 8, backend, device="cpu")(b, ALPHA, BETA, c).numpy()
    want = np.asarray(RefPlan(ref, 8, backend=JAX_BACKEND[backend])(b, ALPHA, BETA, c))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, c * np.float32(BETA))


def test_ell_wrappers_on_cpu():
    coo = MATRICES["hub_rows"]()
    _, port = _packs(coo, 4)
    pl = tx.plan(port, 24, "ell_pallas", device="cpu")
    assert pl.ranges is None
    b, c = _operands(*coo.shape, 24)
    b_p, c_p = pl.pad_b(b), pl.pad_c(c)
    via = spmm_ell_gather_padded(*pl.arrays, b_p, c_p, ALPHA, BETA, m_base=port.m_base)
    ref = spmm_ell_gather_padded_ref(*pl.arrays, b_p, c_p, ALPHA, BETA, m_base=port.m_base)
    assert torch.equal(via, ref) and via.shape == (port.m_padded, 24)
    # the two engines agree on the real rows; the virtual rows differ by the
    # fold order (before or after the epilogue)
    plain = spmm_ell_padded_ref(*pl.arrays, b_p, c_p, ALPHA, BETA, m_base=port.m_base)
    assert (plain[:port.m] - via[:port.m]).abs().max().item() <= _tol(via[:port.m].numpy())
    meta = torch.empty((8, 2), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        spmm_ell_gather_padded(meta, meta, meta, meta, meta, 1.0, 0.0, m_base=4)


@pytest.mark.parametrize(
    "field,value,match",
    [
        ("cols", 150, "column"),
        ("cols", -1, "column"),
        ("fold_rows", 100, "fold_rows"),
        ("m_base", 99, "m_base"),
    ],
)
def test_ell_pack_bounds_checked_before_upload(field, value, match):
    _, port = _packs(MATRICES["hub_rows"](), 4)
    if field == "m_base":
        port.m_base = value
    else:
        arr = getattr(port, field).copy()
        arr.flat[0] = value
        setattr(port, field, arr)
    with pytest.raises(ValueError, match=match):
        check_ell_pack(port)
    with pytest.raises(ValueError, match=match):
        tx.SpmmPlan(port, 8, "ell_pallas", device="cpu")
