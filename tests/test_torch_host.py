"""The PyTorch port's NumPy host layer against the JAX package's.

sextans_tpu_torch carries its own copy of the host layer (Matrix Market I/O,
COO/CSR, the block and slab packers, the golden oracle and the verify gate),
because importing any ``sextans_tpu`` module imports JAX. These tests hold
the copies to the originals: packed arrays byte-identical, files and oracle
outputs equal.
"""

import torch_cpu  # noqa: F401  one torch thread per xdist worker

from dataclasses import asdict

import numpy as np
import pytest

import sextans_tpu_torch as tx
from sextans_tpu.format.coo import COOMatrix as RefCOO
from sextans_tpu.format.csr import CSRMatrix as RefCSR
from sextans_tpu.format.pack import pack as ref_pack
from sextans_tpu.format.pack_edge import PackedSpMatrixEdge as RefEdge
from sextans_tpu.format.pack_edge import pack_edge as ref_pack_edge
from sextans_tpu.format.pack_ell import PackedSpMatrixELL as RefELL
from sextans_tpu.format.pack_ell import pack_ell as ref_pack_ell
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


EDGE_ARRAYS = ("vals", "meta", "chunk_mtile", "chunk_kwin")
ELL_ARRAYS = ("cols", "vals", "fold_rows")


def assert_same_arrays(port, ref, names, scalars):
    for name in names:
        a, b = getattr(port, name), getattr(ref, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert a.tobytes() == b.tobytes(), name
    for name in ("m", "k", "nnz", *scalars):
        assert getattr(port, name) == getattr(ref, name), name
    assert asdict(port.stats) == asdict(ref.stats)
    assert asdict(port.config) == asdict(ref.config)
    for name in ("col_perm", "row_perm"):
        a, b = getattr(port, name), getattr(ref, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert a.tobytes() == b.tobytes(), name


@pytest.mark.parametrize("matrix", sorted(MATRICES))
@pytest.mark.parametrize("lanes,reorder", [(1, False), (4, False), (1, True), (4, True)])
def test_edge_pack_byte_identical(matrix, lanes, reorder):
    port_coo, ref_coo = MATRICES[matrix]()
    kw = dict(tile_m=64, window_k=128, edge_chunk=32, edge_lanes=lanes)
    port = tx.pack_edge(port_coo, tx.SpmmConfig(**kw), reorder_cols=reorder,
                        reorder_rows_=reorder)
    ref = ref_pack_edge(ref_coo, RefConfig(**kw), impl="numpy",
                        reorder_cols=reorder, reorder_rows_=reorder)
    assert_same_arrays(port, ref, EDGE_ARRAYS, ("n_mtiles", "n_kwins"))


def _hub_pair():
    rng = np.random.default_rng(8)
    rows = np.concatenate([np.full(90, 3), np.full(40, 77), rng.integers(0, 120, 300)])
    cols = rng.integers(0, 160, rows.size)
    vals = rng.standard_normal(rows.size).astype(np.float32)
    return _coo_pair((120, 160), rows, cols, vals)


@pytest.mark.parametrize("matrix", sorted(MATRICES) + ["hub_rows"])
@pytest.mark.parametrize("r", [None, 3, 16])
def test_ell_pack_byte_identical(matrix, r):
    port_coo, ref_coo = _hub_pair() if matrix == "hub_rows" else MATRICES[matrix]()
    port = tx.pack_ell(port_coo, tx.SpmmConfig(tile_m=32), slots_per_row=r)
    ref = ref_pack_ell(ref_coo, RefConfig(tile_m=32), slots_per_row=r)
    assert_same_arrays(port, ref, ELL_ARRAYS, ("slots_per_row", "m_base"))
    if matrix == "hub_rows" and r == 3:
        assert port.n_virt > 40


def test_ell_config_r_and_helpers_match_reference():
    from sextans_tpu.format import pack_ell as ref_ell
    from sextans_tpu_torch.format import pack_ell as port_ell

    port_coo, ref_coo = _hub_pair()
    cfg = dict(tile_m=64, ell_r=6)
    assert_same_arrays(tx.pack_ell(port_coo, tx.SpmmConfig(**cfg)),
                       ref_pack_ell(ref_coo, RefConfig(**cfg)), ELL_ARRAYS,
                       ("slots_per_row", "m_base"))
    deg = np.bincount(port_coo.rows, minlength=120)
    for n in (16, 512):
        assert port_ell.choose_slots_per_row(port_coo, n) == \
            ref_ell.choose_slots_per_row(ref_coo, n)
        assert port_ell.ell_traffic_bytes(deg, 4, n) == ref_ell.ell_traffic_bytes(deg, 4, n)
    assert port_ell.ell_bytes_per_nnz(deg, 4, 430, 7) == ref_ell.ell_bytes_per_nnz(deg, 4, 430, 7)
    # the inflation refusal: one row of a huge, nearly empty matrix
    wide_p, wide_r = _coo_pair((300000, 10), [5], [1], [1.0])
    for packer, coo, Cfg in ((tx.pack_ell, wide_p, tx.SpmmConfig),
                             (ref_pack_ell, wide_r, RefConfig)):
        with pytest.raises(ValueError, match="inflation"):
            packer(coo, Cfg(), slots_per_row=4)
    for check in (port_ell.check_ell_inflation, ref_ell.check_ell_inflation):
        with pytest.raises(ValueError, match="inflation"):
            check(np.ones(300000, np.int64), 8, 10)
        check(deg, 4, 430)


@pytest.mark.parametrize("fmt", ["edge", "ell"])
def test_edge_and_ell_save_load_match_reference(tmp_path, fmt):
    port_coo, ref_coo = _hub_pair()
    if fmt == "edge":
        kw = dict(tile_m=64, window_k=64, edge_chunk=16, edge_lanes=2)
        port = tx.pack_edge(port_coo, tx.SpmmConfig(**kw), reorder_cols=True)
        ref = ref_pack_edge(ref_coo, RefConfig(**kw), impl="numpy", reorder_cols=True)
        port_cls, ref_cls, names = tx.PackedSpMatrixEdge, RefEdge, EDGE_ARRAYS
        scalars = ("n_mtiles", "n_kwins")
    else:
        port = tx.pack_ell(port_coo, tx.SpmmConfig(tile_m=32), slots_per_row=4)
        ref = ref_pack_ell(ref_coo, RefConfig(tile_m=32), slots_per_row=4)
        port_cls, ref_cls, names = tx.PackedSpMatrixELL, RefELL, ELL_ARRAYS
        scalars = ("slots_per_row", "m_base")
    port.save(tmp_path / "port.npz")
    ref.save(tmp_path / "ref.npz")
    with np.load(tmp_path / "port.npz") as a, np.load(tmp_path / "ref.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            assert a[key].dtype == b[key].dtype and a[key].tobytes() == b[key].tobytes(), key
    # each package loads the other's file into the same pack
    for path in ("port.npz", "ref.npz"):
        assert_same_arrays(port_cls.load(tmp_path / path), ref_cls.load(tmp_path / path),
                           names, scalars)
    with pytest.raises(ValueError, match="not an"):
        (tx.PackedSpMatrixELL if fmt == "edge" else tx.PackedSpMatrixEdge).load(
            tmp_path / "port.npz")


@pytest.mark.parametrize("reorder", [False, True])
@pytest.mark.parametrize("fmt", ["block", "slab"])
def test_block_and_slab_save_load_match_reference(tmp_path, fmt, reorder):
    port_coo, ref_coo = MATRICES["random"]()
    if fmt == "block":
        kw = dict(tile_m=64, window_k=128, block_k=8, group_blocks=16, precise=1)
        port_packer, ref_packer, idx = tx.pack, ref_pack, "qrow"
        port_cls, other = tx.PackedSpMatrix, tx.PackedSpMatrixMXU
    else:
        kw = dict(tile_m=128, window_k=128, block_k=16, group_blocks=4, tile_n=256)
        port_packer, ref_packer, idx = tx.pack_mxu, ref_pack_mxu, "qm"
        port_cls, other = tx.PackedSpMatrixMXU, tx.PackedSpMatrix
    port = port_packer(port_coo, tx.SpmmConfig(**kw), reorder_cols=reorder,
                       reorder_rows_=reorder)
    ref = ref_packer(ref_coo, RefConfig(**kw), impl="numpy", reorder_cols=reorder,
                     reorder_rows_=reorder)
    port.save(tmp_path / "port.npz")
    ref.save(tmp_path / "ref.npz")
    with np.load(tmp_path / "port.npz") as a, np.load(tmp_path / "ref.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            assert a[key].dtype == b[key].dtype and a[key].tobytes() == b[key].tobytes(), key
    ref_cls = type(ref)
    for path in ("port.npz", "ref.npz"):  # each package loads the other's file
        got, want = port_cls.load(tmp_path / path), ref_cls.load(tmp_path / path)
        assert_same_pack(got, want, idx)
        assert_same_pack(got, port, idx)
    if fmt == "block":  # the block load does not check the format (as in the JAX package)
        with pytest.raises(ValueError, match="not an MXU"):
            other.load(tmp_path / "port.npz")


def _same_sharded(port, ref):
    for name in ("m", "k", "nnz", "n_shards", "m_local", "n_mtiles_local", "n_kwins", "mode",
                 "fmt", "m_padded", "k_padded", "n_groups"):
        assert getattr(port, name) == getattr(ref, name), name
    assert asdict(port.config) == asdict(ref.config)
    for name in ("vals", "qrow", "bcol", "group_mtile", "group_kwin", "tile_assign",
                 "shard_nnz"):
        a, b = getattr(port, name), getattr(ref, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert a.dtype == b.dtype and a.shape == b.shape, name
            assert a.tobytes() == b.tobytes(), name
    assert len(port.shards) == len(ref.shards)
    assert port.nnz_imbalance == ref.nnz_imbalance


SHARD_CFGS = {"vpu": dict(tile_m=64, window_k=128, block_k=8, group_blocks=16),
              "mxu": dict(tile_m=128, window_k=128, block_k=16, group_blocks=4),
              "edge": dict(tile_m=64, window_k=128, edge_chunk=32, edge_lanes=2),
              "ell": dict(tile_m=64)}


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("fmt", sorted(SHARD_CFGS))
def test_partition_byte_identical(fmt, shards):
    from sextans_tpu.parallel import partition as ref_part
    from sextans_tpu_torch.parallel import partition as port_part

    port_coo, ref_coo = _hub_pair() if fmt == "ell" else MATRICES["empty_mtiles"]()
    cfg, ref_cfg = tx.SpmmConfig(**SHARD_CFGS[fmt]), RefConfig(**SHARD_CFGS[fmt])
    for balance in ("contiguous", "nnz"):
        _same_sharded(tx.pack_sharded(port_coo, shards, cfg, fmt=fmt, balance=balance),
                      ref_part.pack_sharded(ref_coo, shards, ref_cfg, fmt=fmt, balance=balance))
    _same_sharded(tx.pack_sharded_k(port_coo, shards, cfg, fmt=fmt),
                  ref_part.pack_sharded_k(ref_coo, shards, ref_cfg, fmt=fmt))
    if fmt == "ell":
        return
    # the padding alone: a pack grown by a few groups (chunks), as serving pads it
    packer = {"vpu": (tx.pack, ref_pack), "mxu": (tx.pack_mxu, ref_pack_mxu),
              "edge": (tx.pack_edge, ref_pack_edge)}[fmt]
    port_p = packer[0](port_coo, cfg, reorder_cols=True)
    ref_p = packer[1](ref_coo, ref_cfg, impl="numpy", reorder_cols=True)
    units = port_p.n_chunks if fmt == "edge" else port_p.n_groups
    got = port_part._pad_shard_groups(port_p, units + shards)
    want = ref_part._pad_shard_groups(ref_p, units + shards)
    if fmt == "edge":
        assert_same_arrays(got, want, EDGE_ARRAYS, ("n_mtiles", "n_kwins"))
    else:
        assert_same_pack(got, want, "qm" if fmt == "mxu" else "qrow")
    assert port_part._pad_shard_groups(port_p, units) is port_p


def test_pack_impl_choices():
    coo, _ = MATRICES["random"]()
    cfg = tx.SpmmConfig(tile_m=128, window_k=128, block_k=8, group_blocks=16)
    assert tx.pack(coo, cfg, impl="auto").vals.tobytes() == \
        tx.pack(coo, cfg, impl="numpy").vals.tobytes()
    assert tx.pack_edge(coo, cfg, impl="auto").meta.tobytes() == \
        tx.pack_edge(coo, cfg, impl="numpy").meta.tobytes()
    for packer in (tx.pack, tx.pack_mxu, tx.pack_edge):
        with pytest.raises(NotImplementedError, match="native"):
            packer(coo, cfg, impl="native")
        with pytest.raises(ValueError, match="impl"):
            packer(coo, cfg, impl="fortran")


@pytest.mark.parametrize("fmt", ["edge", "ell"])
def test_from_reference_carries_edge_and_ell_packs(fmt):
    port_coo, ref_coo = _hub_pair()
    if fmt == "edge":
        kw = dict(tile_m=64, window_k=64, edge_chunk=16)
        port = tx.pack_edge(port_coo, tx.SpmmConfig(**kw), reorder_rows_=True)
        ref = ref_pack_edge(ref_coo, RefConfig(**kw), impl="numpy", reorder_rows_=True)
        names, scalars = EDGE_ARRAYS, ("n_mtiles", "n_kwins")
    else:
        port = tx.pack_ell(port_coo, tx.SpmmConfig(tile_m=32))
        ref = ref_pack_ell(ref_coo, RefConfig(tile_m=32))
        names, scalars = ELL_ARRAYS, ("slots_per_row", "m_base")
    converted = from_reference(ref)
    assert type(converted) is type(port)
    assert_same_arrays(converted, ref, names, scalars)
    assert_same_arrays(from_reference(converted), port, names, scalars)


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
