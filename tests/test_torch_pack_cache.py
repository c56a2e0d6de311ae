"""The port's disk pack cache (format/pack_cache.py) and its upload memo.

The tests of ``tests/test_pack_cache.py``, on the port (its plans on the
CPU), and the cache across packages: both write the same files under the
same names, so one directory serves both, ``.npz`` and raw entries alike.
"""

import warnings

import numpy as np
import pytest
import torch

import sextans_tpu_torch as tx
from sextans_tpu.format.coo import COOMatrix as RefCOO
from sextans_tpu.format.pack_cache import PackCache as RefCache
from sextans_tpu.format.pack_cache import pack_signature as ref_signature
from sextans_tpu.utils.config import SpmmConfig as RefConfig
from sextans_tpu_torch.format.pack_cache import PackCache, pack_signature

CFG = tx.SpmmConfig(tile_m=32, window_k=64, block_k=8, group_blocks=16)
FORMAT_ARRAYS = {"vpu": ("vals", "qrow", "bcol", "group_mtile", "group_kwin"),
                 "mxu": ("vals", "qm", "bcol", "group_mtile", "group_kwin"),
                 "edge": ("vals", "meta", "chunk_mtile", "chunk_kwin"),
                 "ell": ("cols", "vals", "fold_rows")}
RAW_CFGS = {
    "vpu": dict(tile_m=64),
    "mxu": dict(tile_m=128, window_k=1024, block_k=128, group_blocks=2),
    "edge": dict(tile_m=64, edge_chunk=512),
    "ell": dict(tile_m=64, ell_r=4),
}


def _coo(seed=0, m=64, k=96, nnz=300):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, m, nnz).astype(np.int32)
    cols = rng.integers(0, k, nnz).astype(np.int32)
    vals = rng.standard_normal(nnz).astype(np.float32)
    vals[vals == 0] = 1.0
    return tx.COOMatrix((m, k), rows, cols, vals)


def _want(coo, b):
    return tx.golden_spmm_exact(tx.CSRMatrix.from_coo(coo), b, 1.0, 0.0, None)


def _assert_same(a, b, fmt):
    for name in FORMAT_ARRAYS[fmt]:
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and x.shape == y.shape and x.tobytes() == y.tobytes(), name


@pytest.mark.parametrize("fmt", ["vpu", "mxu", "edge"])
def test_roundtrip_all_formats(tmp_path, fmt):
    coo = _coo(m=256)
    cfg = CFG.with_(tile_m=128) if fmt == "mxu" else CFG
    cache = PackCache(root=tmp_path)
    p1 = cache.get_or_pack("t", coo, cfg, fmt)
    assert cache.misses == 1
    p2 = cache.get_or_pack("t", coo, cfg, fmt)
    assert cache.hits == 1
    np.testing.assert_array_equal(p1.vals, p2.vals)
    cache2 = PackCache(root=tmp_path)
    p3 = cache2.get_or_pack("t", coo, cfg, fmt)
    assert cache2.disk_hits == 1 and cache2.misses == 0
    _assert_same(p1, p3, fmt)


def test_kernel_knobs_share_one_pack(tmp_path):
    coo = _coo()
    cache = PackCache(root=tmp_path)
    p1 = cache.get_or_pack("t", coo, CFG, "vpu")
    p2 = cache.get_or_pack("t", coo, CFG.with_(precise=True), "vpu")
    assert cache.misses == 1 and cache.hits == 1
    assert p2.config.precise and not p1.config.precise
    assert p2.vals is p1.vals


def test_content_change_does_not_alias(tmp_path):
    cache = PackCache(root=tmp_path)
    p1 = cache.get_or_pack("same-name", _coo(seed=1), CFG, "vpu")
    p2 = cache.get_or_pack("same-name", _coo(seed=2), CFG, "vpu")
    assert cache.misses == 2
    assert not np.array_equal(p1.vals, p2.vals)


def test_signature_separates_formats_and_reorder_as_the_jax_one():
    keys = [(CFG, "vpu", False, False), (CFG, "vpu", True, False), (CFG, "mxu", False, False),
            (CFG, "edge", False, False), (CFG.with_(ell_r=3), "ell", False, False),
            (CFG, "vpu", True, True), (CFG.with_(interleave=False), "vpu", False, False)]
    sigs = [pack_signature(*key) for key in keys]
    assert len(set(sigs)) == len(sigs)
    from dataclasses import asdict

    assert sigs == [ref_signature(RefConfig(**asdict(cfg)), *rest) for cfg, *rest in keys]
    # kernel-only knobs stay outside the key
    assert pack_signature(CFG.with_(precise=2, tile_n=256), "vpu", False) == sigs[0]
    with pytest.raises(ValueError, match="unknown pack format"):
        pack_signature(CFG, "csr", False)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_device_upload_memo_across_n_and_precise(tmp_path, backend):
    """A plain and a precise variant of one cached pack, at two N: one
    upload, one host scan."""
    coo = _coo()
    cache = PackCache(root=tmp_path)
    p1 = cache.get_or_pack("t", coo, CFG, "vpu")
    p2 = cache.get_or_pack("t", coo, CFG.with_(precise=1), "vpu")
    plan16 = tx.SpmmPlan(p1, 16, backend, device="cpu")
    plan32 = tx.SpmmPlan(p2, 32, backend, device="cpu")
    assert all(a is b for a, b in zip(plan16.arrays, plan32.arrays))
    assert plan16.ranges is plan32.ranges
    assert plan16.image is None and plan32.image is None  # K1's tiles: the card only
    b = np.ones((coo.shape[1], 16), np.float32)
    np.testing.assert_allclose(plan16(b).numpy(), _want(coo, b), rtol=1e-5, atol=1e-5)
    b32 = np.ones((coo.shape[1], 32), np.float32)
    np.testing.assert_allclose(plan32(b32).numpy(), _want(coo, b32), rtol=1e-5, atol=1e-5)


def test_correct_result_through_disk_cache(tmp_path):
    coo = _coo(seed=5)
    PackCache(root=tmp_path).get_or_pack("t", coo, CFG, "edge")
    fresh = PackCache(root=tmp_path)
    pe = fresh.get_or_pack("t", coo, CFG, "edge")
    assert fresh.disk_hits == 1
    b = np.ones((coo.shape[1], 16), np.float32)
    got = tx.SpmmPlan(pe, 16, "edge", device="cpu")(b).numpy()
    np.testing.assert_allclose(got, _want(coo, b), rtol=1e-5, atol=1e-5)


def test_hybrid_split_save_load_round_trip(tmp_path):
    split = tx.split_structure(_coo(seed=7), n=16)
    path = tmp_path / "split.npz"
    split.save(path)
    back = tx.HybridSplit.load(path)
    assert (back.m, back.k, back.nnz) == (split.m, split.k, split.nnz)
    for name in ("diag_offsets", "diag_vals", "head_cols", "head_dense", "head_rows",
                 "head_rows_dense"):
        np.testing.assert_array_equal(getattr(back, name), getattr(split, name))
    np.testing.assert_array_equal(back.residue.rows, split.residue.rows)
    np.testing.assert_array_equal(back.residue.vals, split.residue.vals)


def test_get_or_split_disk_round_trip(tmp_path):
    coo = _coo(seed=9)
    cache = PackCache(root=tmp_path)
    s1 = cache.get_or_split("t", coo, n=32)
    assert cache.misses == 1
    s2 = cache.get_or_split("t", coo, n=32)
    assert cache.hits == 1 and s2 is s1
    fresh = PackCache(root=tmp_path)
    s3 = fresh.get_or_split("t", coo, n=32)
    assert fresh.disk_hits == 1
    assert s3.summary() == s1.summary()
    fresh.get_or_split("t", coo, n=512)
    assert fresh.misses == 1


def test_get_or_split_version_invalidates(tmp_path, monkeypatch):
    import sextans_tpu_torch.ops.hybrid as hybrid_mod

    coo = _coo(seed=9)
    PackCache(root=tmp_path).get_or_split("t", coo, n=32)
    monkeypatch.setattr(hybrid_mod, "SPLIT_VERSION", 9999)
    fresh = PackCache(root=tmp_path)
    fresh.get_or_split("t", coo, n=32)
    assert fresh.misses == 1 and fresh.disk_hits == 0


@pytest.mark.parametrize("precise", [0, 1])
def test_hybrid_plan_residue_through_cache(tmp_path, precise):
    coo = _coo(seed=11)
    split = tx.split_structure(coo, n=16)
    assert split.residue.nnz
    cache = PackCache(root=tmp_path)
    kw = dict(backend="xla", residue_config=CFG, residue_fmt="vpu", precise=precise,
              device="cpu")
    plan = tx.HybridSpmmPlan(split, 16, pack_cache=cache, cache_name="t@n16-residue", **kw)
    assert cache.misses == 1
    b = np.ones((coo.shape[1], 16), np.float32)
    got = plan(b, 1.0, 0.0, None)
    np.testing.assert_allclose(got.numpy(), _want(coo, b), rtol=1e-5, atol=1e-5)
    # the uncached plan's bits
    assert torch.equal(got, tx.HybridSpmmPlan(split, 16, **kw)(b, 1.0, 0.0, None))
    plan2 = tx.HybridSpmmPlan(split, 16, pack_cache=cache, cache_name="t@n16-residue", **kw)
    assert cache.misses == 1
    assert plan2.residue_plan.arrays[0] is plan.residue_plan.arrays[0]
    assert torch.equal(plan2(b, 1.0, 0.0, None), got)


def test_raw_memmap_cache_roundtrip(tmp_path, monkeypatch):
    """Packs above SEXTANS_PACK_RAW_BYTES go to the raw npy-dir store and
    load back memmapped (read-only), byte-identical, for every format; the
    upload copies them on the host, without a warning, so no tensor
    aliases the mapping."""
    monkeypatch.setenv("SEXTANS_PACK_RAW_BYTES", "1")
    coo = tx.COOMatrix.random(300, 400, 3000, seed=11)
    backends = {"vpu": "pallas", "mxu": "mxu", "edge": "edge", "ell": "ell"}
    b = np.random.default_rng(12).standard_normal((400, 16)).astype(np.float32)
    want = _want(coo, b)
    for fmt, kw in RAW_CFGS.items():
        cfg = tx.SpmmConfig(**kw)
        cache = PackCache(tmp_path / fmt)
        p1 = cache.get_or_pack("m", coo, cfg, fmt)
        raw_dirs = list((tmp_path / fmt).glob("*.raw"))
        assert cache.misses == 1 and len(raw_dirs) == 1 and raw_dirs[0].is_dir(), fmt
        cache2 = PackCache(tmp_path / fmt)
        p2 = cache2.get_or_pack("m", coo, cfg, fmt)
        assert cache2.disk_hits == 1, fmt
        _assert_same(p1, p2, fmt)
        assert isinstance(p2.vals, np.memmap) and not p2.vals.flags.writeable
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            plan = tx.SpmmPlan(p2, 16, backends[fmt], device="cpu")
        vals = plan.arrays[0]
        vals.view(-1)[0] += 1.0  # a copy: the mapping stays as it was
        assert p2.vals.reshape(-1)[0] == p1.vals.reshape(-1)[0]
        vals.view(-1)[0] -= 1.0
        got = plan(b, 1.0, 0.0).numpy()
        assert tx.verify(want, got).passed, fmt
        assert torch.equal(plan(b), tx.SpmmPlan(p1, 16, backends[fmt], device="cpu")(b))


def _ref_coo(coo):
    return RefCOO(coo.shape, coo.rows, coo.cols, coo.vals)


@pytest.mark.parametrize("raw", [False, True])
@pytest.mark.parametrize("fmt", sorted(RAW_CFGS))
def test_one_cache_directory_serves_both_packages(tmp_path, monkeypatch, fmt, raw):
    """Each package reads the other's entries (``disk_hits``), byte for
    byte, and both write them under the same names."""
    if raw:
        monkeypatch.setenv("SEXTANS_PACK_RAW_BYTES", "1")
    coo = tx.COOMatrix.random(300, 400, 3000, seed=13)
    kw = RAW_CFGS[fmt]
    cfg, ref_cfg = tx.SpmmConfig(**kw), RefConfig(**kw)
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    written_by_jax = RefCache(jax_dir).get_or_pack("m", _ref_coo(coo), ref_cfg, fmt)
    written_by_port = PackCache(port_dir).get_or_pack("m", coo, cfg, fmt)
    names = sorted(p.name for p in jax_dir.iterdir())
    assert names == sorted(p.name for p in port_dir.iterdir())
    assert len(names) == 1 and names[0].endswith(".raw" if raw else ".npz")
    port_reads = PackCache(jax_dir)
    got = port_reads.get_or_pack("m", coo, cfg, fmt)
    assert port_reads.disk_hits == 1 and port_reads.misses == 0
    jax_reads = RefCache(port_dir)
    want = jax_reads.get_or_pack("m", _ref_coo(coo), ref_cfg, fmt)
    assert jax_reads.disk_hits == 1 and jax_reads.misses == 0
    for a, b in ((got, written_by_jax), (want, written_by_port), (got, written_by_port)):
        _assert_same(a, b, fmt)
        assert (a.m, a.k, a.nnz) == (b.m, b.k, b.nnz)


def test_split_cache_serves_both_packages(tmp_path):
    coo = _coo(seed=9)
    ref = RefCache(tmp_path).get_or_split("t", _ref_coo(coo), n=32)
    port = PackCache(tmp_path)
    got = port.get_or_split("t", coo, n=32)
    assert port.disk_hits == 1 and port.misses == 0
    assert got.summary() == ref.summary()
    np.testing.assert_array_equal(got.diag_vals, ref.diag_vals)
