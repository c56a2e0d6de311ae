"""The PyTorch port's NumPy host layer against the JAX package's.

sextans_tpu_torch carries its own copy of the host layer (Matrix Market I/O,
COO/CSR, the block and slab packers, the golden oracle and the verify gate),
because importing any ``sextans_tpu`` module imports JAX. These tests hold
the copies to the originals: packed arrays byte-identical, files and oracle
outputs equal.
"""

from dataclasses import asdict

import numpy as np
import pytest

import sextans_tpu_torch as tx
from sextans_tpu.format.coo import COOMatrix as RefCOO
from sextans_tpu.format.csr import CSRMatrix as RefCSR
from sextans_tpu.format.pack import pack as ref_pack
from sextans_tpu.format.pack_mxu import pack_mxu as ref_pack_mxu
from sextans_tpu.io import mtx as ref_mtx
from sextans_tpu.ops import golden as ref_golden
from sextans_tpu.utils import verify as ref_verify
from sextans_tpu.utils.config import SpmmConfig as RefConfig
from sextans_tpu_torch.format.convert import from_reference


def _coo_pair(shape, rows, cols, vals):
    rows, cols, vals = (np.asarray(a) for a in (rows, cols, vals))
    return (
        tx.COOMatrix(shape, rows, cols, vals),
        RefCOO(shape, rows, cols, vals),
    )


def _random_pair(m, k, nnz, seed, **kw):
    ref = RefCOO.random(m, k, nnz, seed=seed, **kw)
    return tx.COOMatrix(ref.shape, ref.rows, ref.cols, ref.vals), ref


def _empty_tiles_pair(seed=4):
    # rows only in the first 100 rows: later M-tiles get padding-only groups
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 100, 800)
    cols = rng.integers(0, 600, 800)
    vals = rng.standard_normal(800).astype(np.float32)
    return _coo_pair((700, 600), rows, cols, vals)


def _duplicates_pair(seed=5):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 40, 600)  # heavy duplication: 600 entries in 40x50
    cols = rng.integers(0, 50, 600)
    vals = rng.standard_normal(600).astype(np.float32)
    return _coo_pair((130, 70), rows, cols, vals)


MATRICES = {
    "random": lambda: _random_pair(300, 400, 3000, seed=1),
    "banded_ragged": lambda: _random_pair(259, 131, 1500, seed=2, banded=True, bandwidth=20),
    "empty_mtiles": _empty_tiles_pair,
    "duplicates": _duplicates_pair,
    "nnz0": lambda: _coo_pair((90, 33), [], [], []),
}


def assert_same_pack(port, ref, idx_name):
    for name in ("vals", idx_name, "bcol", "group_mtile", "group_kwin"):
        a, b = getattr(port, name), getattr(ref, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert a.tobytes() == b.tobytes(), name
    for name in ("m", "k", "nnz", "n_mtiles", "n_kwins"):
        assert getattr(port, name) == getattr(ref, name), name
    assert asdict(port.stats) == asdict(ref.stats)
    assert asdict(port.config) == asdict(ref.config)
    for name in ("col_perm", "row_perm"):
        a, b = getattr(port, name), getattr(ref, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert a.tobytes() == b.tobytes(), name


@pytest.mark.parametrize("matrix", sorted(MATRICES))
@pytest.mark.parametrize(
    "bk,interleave,reorder",
    [(8, True, False), (2, True, False), (32, False, False), (8, True, True)],
)
def test_block_pack_byte_identical(matrix, bk, interleave, reorder):
    port_coo, ref_coo = MATRICES[matrix]()
    kw = dict(tile_m=64, window_k=128, block_k=bk, group_blocks=max(16, 128 // bk),
              interleave=interleave)
    port = tx.pack(port_coo, tx.SpmmConfig(**kw), reorder_cols=reorder,
                   reorder_rows_=reorder)
    ref = ref_pack(ref_coo, RefConfig(**kw), impl="numpy", reorder_cols=reorder,
                   reorder_rows_=reorder)
    assert_same_pack(port, ref, "qrow")


@pytest.mark.parametrize("matrix", sorted(MATRICES))
@pytest.mark.parametrize("bk,reorder", [(8, False), (16, True), (128, False)])
def test_slab_pack_byte_identical(matrix, bk, reorder):
    port_coo, ref_coo = MATRICES[matrix]()
    kw = dict(tile_m=256, window_k=256, block_k=bk, group_blocks=4)
    port = tx.pack_mxu(port_coo, tx.SpmmConfig(**kw), reorder_cols=reorder,
                       reorder_rows_=reorder)
    ref = ref_pack_mxu(ref_coo, RefConfig(**kw), impl="numpy",
                       reorder_cols=reorder, reorder_rows_=reorder)
    assert_same_pack(port, ref, "qm")


def test_pack_impl_choices():
    coo, _ = MATRICES["random"]()
    cfg = tx.SpmmConfig(tile_m=128, window_k=128, block_k=8, group_blocks=16)
    assert tx.pack(coo, cfg, impl="auto").vals.tobytes() == \
        tx.pack(coo, cfg, impl="numpy").vals.tobytes()
    for packer in (tx.pack, tx.pack_mxu):
        with pytest.raises(NotImplementedError, match="native"):
            packer(coo, cfg, impl="native")
        with pytest.raises(ValueError, match="impl"):
            packer(coo, cfg, impl="fortran")


@pytest.mark.parametrize("fmt", ["block", "slab"])
def test_from_reference_round_trip(fmt):
    port_coo, ref_coo = _random_pair(200, 300, 1500, seed=7)
    if fmt == "block":
        kw = dict(tile_m=64, window_k=128, block_k=8, group_blocks=16)
        port = tx.pack(port_coo, tx.SpmmConfig(**kw), reorder_cols=True)
        ref = ref_pack(ref_coo, RefConfig(**kw), impl="numpy", reorder_cols=True)
        idx = "qrow"
    else:
        kw = dict(tile_m=128, window_k=128, block_k=16, group_blocks=4)
        port = tx.pack_mxu(port_coo, tx.SpmmConfig(**kw), reorder_rows_=True)
        ref = ref_pack_mxu(ref_coo, RefConfig(**kw), impl="numpy", reorder_rows_=True)
        idx = "qm"
    converted = from_reference(ref)
    assert type(converted) is type(port)
    assert_same_pack(converted, ref, idx)
    assert_same_pack(converted, port, idx)
    # the conversion is duck-typed, so it takes the port's own packs too
    assert_same_pack(from_reference(converted), port, idx)


def test_from_reference_rejects_non_packs():
    with pytest.raises(TypeError, match="qrow/qm"):
        from_reference(object())


def test_config_validation_matches_reference():
    bad = [
        dict(tile_m=12), dict(block_k=3), dict(window_k=100, block_k=8),
        dict(group_blocks=0), dict(tile_n=100), dict(n_acc=0), dict(precise=3),
        dict(edge_chunk=12), dict(edge_lanes=3), dict(ell_r=0),
    ]
    for kw in bad:
        with pytest.raises(ValueError):
            RefConfig(**kw)
        with pytest.raises(ValueError):
            tx.SpmmConfig(**kw)
    with pytest.raises(ValueError, match="group_blocks"):
        tx.pack(MATRICES["random"]()[0], tx.SpmmConfig(block_k=8, group_blocks=8))
    for n in (1, 100, 129, 2000):
        assert tx.SpmmConfig().resolve_tile_n(n) == RefConfig().resolve_tile_n(n)


MTX_CASES = {
    "general": "%%MatrixMarket matrix coordinate real general\n% c\n3 4 4\n"
               "1 1 1.5\n2 3 -2\n3 4 0\n3 1 7e-3\n",
    "symmetric": "%%MatrixMarket matrix coordinate real symmetric\n3 3 3\n"
                 "1 1 2\n2 1 -1\n3 2 4.25\n",
    "skew": "%%MatrixMarket matrix coordinate real skew-symmetric\n3 3 2\n"
            "2 1 1\n3 1 -3\n",
    "pattern": "%%MatrixMarket matrix coordinate pattern general\n2 3 3\n"
               "1 1\n2 3\n1 3\n",
    "integer_crlf": "%%MatrixMarket matrix coordinate integer general\r\n2 2 2\r\n"
                    "1 2 5\r\n2 1 -6\r\n",
}


@pytest.mark.parametrize("case", sorted(MTX_CASES))
def test_read_mtx_matches_reference(tmp_path, case):
    path = tmp_path / "a.mtx"
    path.write_bytes(MTX_CASES[case].encode())
    h1, *a1 = tx.read_mtx_coo(path)
    h2, *a2 = ref_mtx.read_mtx_coo(path)
    assert h1.__dict__ == h2.__dict__
    for x, y in zip(a1, a2):
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes()
    p, r = tx.read_mtx(path), ref_mtx.read_mtx(path)
    assert p.shape == r.shape and p.vals.tobytes() == r.vals.tobytes()


def test_read_mtx_rejects_what_reference_rejects(tmp_path):
    bad = {
        "array": "%%MatrixMarket matrix array real general\n2 2\n1\n2\n3\n4\n",
        "complex": "%%MatrixMarket matrix coordinate complex general\n1 1 1\n1 1 1 0\n",
        "range": "%%MatrixMarket matrix coordinate real general\n2 2 1\n3 1 1\n",
        "truncated": "%%MatrixMarket matrix coordinate real general\n2 2 3\n1 1 1\n",
    }
    for name, text in bad.items():
        path = tmp_path / f"{name}.mtx"
        path.write_text(text)
        with pytest.raises(ValueError):
            ref_mtx.read_mtx_coo(path)
        with pytest.raises(ValueError):
            tx.read_mtx_coo(path)


def test_write_mtx_matches_reference(tmp_path):
    port_coo, ref_coo = _random_pair(50, 60, 300, seed=9)
    tx.write_mtx(tmp_path / "p.mtx", port_coo, comment="two\nlines")
    ref_mtx.write_mtx(tmp_path / "r.mtx", ref_coo, comment="two\nlines")
    assert (tmp_path / "p.mtx").read_bytes() == (tmp_path / "r.mtx").read_bytes()
    back = tx.read_mtx(tmp_path / "p.mtx")
    assert back.vals.tobytes() == port_coo.vals.tobytes()


def test_coo_constructors_match_reference():
    rng = np.random.default_rng(3)
    dense = rng.standard_normal((20, 30)).astype(np.float32)
    dense[rng.random(dense.shape) < 0.7] = 0.0
    dense[0, 0] = -0.0  # kept: nonzero bit pattern
    for a, b in ((tx.COOMatrix.from_dense(dense), RefCOO.from_dense(dense)),
                 (tx.COOMatrix.random(40, 50, 300, seed=2, banded=True),
                  RefCOO.random(40, 50, 300, seed=2, banded=True))):
        for name in ("rows", "cols", "vals"):
            assert getattr(a, name).tobytes() == getattr(b, name).tobytes()
    with pytest.raises(ValueError):
        tx.COOMatrix((2, 2), [0, 2], [0, 0], [1.0, 1.0])


@pytest.mark.parametrize("with_c", [True, False])
def test_golden_and_verify_match_reference(with_c):
    port_coo, ref_coo = _random_pair(120, 90, 900, seed=11)
    rng = np.random.default_rng(0)
    b = rng.standard_normal((90, 24)).astype(np.float32)
    c = rng.standard_normal((120, 24)).astype(np.float32) if with_c else None
    beta = -2.06 if with_c else 0.0
    pcsr, rcsr = tx.CSRMatrix.from_coo(port_coo), RefCSR.from_coo(ref_coo)
    g1 = tx.golden_spmm(pcsr, b, 0.85, beta, c)
    g2 = ref_golden.golden_spmm(rcsr, b, 0.85, beta, c)
    e1 = tx.golden_spmm_exact(pcsr, b, 0.85, beta, c)
    e2 = ref_golden.golden_spmm_exact(rcsr, b, 0.85, beta, c)
    assert g1.tobytes() == g2.tobytes() and e1.tobytes() == e2.tobytes()
    noisy = g1 + np.float32(1e-3) * (rng.random(g1.shape) < 0.05)
    assert asdict(tx.verify(e1, noisy)) == asdict(ref_verify.verify(e2, noisy))
    assert tx.gflops(900, 120, 24, 1e-3) == ref_verify.gflops(900, 120, 24, 1e-3)
    assert tx.spmm_flops(900, 120, 24) == ref_golden.spmm_flops(900, 120, 24)
