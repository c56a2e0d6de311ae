"""Serving (ops/serve.py) in the PyTorch port against the JAX package's.

``bucket_up`` and ``bucketize_pack`` are held byte-identical to
``sextans_tpu.ops.serve``'s; the port's served products, on the CPU, within
``4 * spacing(f32(max|C|))`` of the JAX package's (its ``ServePlan`` on
``xla`` and ``ell``, its ``SpmmPlan`` on the JAX-bucketized pack through
``mxu_interpret`` and ``edge_interpret``) and equal to the bit to the port's
own plan on the unbucketed pack. Then the server: two matrices in one
bucket, the pack cache, and the errors the JAX server raises.
"""

import dataclasses
from dataclasses import asdict

import numpy as np
import pytest
import torch

import sextans_tpu_torch as tx
from sextans_tpu.format.coo import COOMatrix as RefCOO
from sextans_tpu.format.pack import pack as ref_pack
from sextans_tpu.format.pack_edge import pack_edge as ref_pack_edge
from sextans_tpu.format.pack_ell import pack_ell as ref_pack_ell
from sextans_tpu.format.pack_mxu import pack_mxu as ref_pack_mxu
from sextans_tpu.ops.plan import SpmmPlan as RefPlan
from sextans_tpu.ops.serve import ServePlan as RefServePlan
from sextans_tpu.ops.serve import SpmmServer as RefServer
from sextans_tpu.ops.serve import bucket_up as ref_bucket_up
from sextans_tpu.ops.serve import bucketize_pack as ref_bucketize
from sextans_tpu.utils.config import SpmmConfig as RefConfig
from sextans_tpu_torch.format.convert import from_reference
from sextans_tpu_torch.ops.launch import check_ell_pack, ell_fold_count
from sextans_tpu_torch.ops.spmm_ell import spmm_ell_gather_padded_ref, spmm_ell_padded_ref
from sextans_tpu_torch.ops.serve import bucket_up, bucketize_pack

ALPHA, BETA = 0.85, -2.06
CFGS = {
    "vpu": dict(tile_m=64, window_k=256, block_k=8, group_blocks=16),
    "mxu": dict(tile_m=128, window_k=256, block_k=8, group_blocks=4),
    "edge": dict(tile_m=64, window_k=256, edge_chunk=64, edge_lanes=4),
    "ell": dict(tile_m=64, ell_r=2),
}
PACKERS = {"vpu": (tx.pack, ref_pack), "mxu": (tx.pack_mxu, ref_pack_mxu),
           "edge": (tx.pack_edge, ref_pack_edge), "ell": (tx.pack_ell, ref_pack_ell)}
ARRAYS = {"vpu": ("vals", "qrow", "bcol", "group_mtile", "group_kwin"),
          "mxu": ("vals", "qm", "bcol", "group_mtile", "group_kwin"),
          "edge": ("vals", "meta", "chunk_mtile", "chunk_kwin"),
          "ell": ("cols", "vals", "fold_rows")}
SCALARS = {"ell": ("m", "k", "nnz", "slots_per_row", "m_base", "n_virt", "m_padded")}


def _lin_coo(m, k, nnz, seed):
    rng = np.random.default_rng(seed)
    lin = rng.choice(m * k, size=nnz, replace=False).astype(np.int64)
    return ((m, k), (lin // k).astype(np.int32), (lin % k).astype(np.int32),
            rng.standard_normal(nnz).astype(np.float32))


def _hub_coo(seed=21):
    """Low-degree rows and three hub rows of degree 42: 63 virtual rows at
    R = 2, which the bucket pads to 75."""
    m, k = 150, 200
    rng = np.random.default_rng(seed)
    rows = [np.repeat(np.arange(m, dtype=np.int32), 2)]
    cols = [np.tile(rng.choice(k, size=2, replace=False), m).astype(np.int32)]
    for hub in (5, 70, 140):
        rows.append(np.full(42, hub, dtype=np.int32))
        cols.append(rng.choice(k, size=42, replace=False).astype(np.int32))
    rr, cc = np.concatenate(rows), np.concatenate(cols)
    _, keep = np.unique(rr.astype(np.int64) * k + cc, return_index=True)
    return (m, k), rr[keep], cc[keep], rng.standard_normal(keep.size).astype(np.float32)


def _pair(fmt, seed=2, shape=(190, 280), nnz=2400):
    """The same matrix packed by both packages in ``fmt``."""
    args = _hub_coo() if fmt == "ell" else _lin_coo(*shape, nnz, seed)
    port_pack, ref_packer = PACKERS[fmt]
    kw = {} if fmt == "ell" else dict(impl="numpy")
    return (port_pack(tx.COOMatrix(*args), tx.SpmmConfig(**CFGS[fmt])),
            ref_packer(RefCOO(*args), RefConfig(**CFGS[fmt]), **kw))


def _operands(m, k, n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((k, n)).astype(np.float32),
            rng.standard_normal((m, n)).astype(np.float32))


def _tol(c):
    return 4 * float(np.spacing(np.float32(np.abs(c).max())))


@pytest.mark.parametrize("growth", [1.25, 1.5])
def test_bucket_up_matches_reference(growth):
    got = [bucket_up(x, growth) for x in range(1, 5001)]
    assert got == [ref_bucket_up(x, growth) for x in range(1, 5001)]
    assert all(bucket_up(b, growth) == b for b in set(got))  # idempotent on buckets


@pytest.mark.parametrize("fmt", sorted(CFGS))
def test_bucketize_pack_byte_identical(fmt):
    port, ref = _pair(fmt)
    got, want = bucketize_pack(port), ref_bucketize(ref)
    for name in ARRAYS[fmt]:
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(), name
    for name in SCALARS.get(fmt, ("m", "k", "nnz", "n_mtiles", "n_kwins", "m_padded",
                                  "k_padded")):
        assert getattr(got, name) == getattr(want, name), name
    assert asdict(got.stats) == asdict(want.stats)
    assert getattr(got, "k_bucket", None) == getattr(want, "k_bucket", None)
    if fmt == "ell":
        assert got.n_virt > port.n_virt > 0 and got.m_base > got.m and got.k_bucket > got.k
    else:  # the padding grew every bucketed dimension it could
        units = "n_chunks" if fmt == "edge" else "n_groups"
        assert getattr(got, units) > getattr(port, units)


def test_bucketized_ell_pack_uploads_and_converts():
    port, ref = _pair("ell")
    bucketed = ref_bucketize(ref)
    converted = from_reference(bucketed)
    assert converted.k_bucket == bucketed.k_bucket
    assert converted.m_base > converted.m
    check_ell_pack(converted)  # m_base past m, over all-zero pad rows
    bad = bucketize_pack(port)
    bad.vals[bad.m] = 1.0  # a nonzero value in a pad row
    with pytest.raises(ValueError, match="pad rows"):
        check_ell_pack(bad)
    b, c = _operands(port.m, port.k, 16)
    for backend in ("ell", "ell_pallas"):  # ell_pallas runs its plain version here
        got = tx.SpmmPlan(converted, 16, backend, device="cpu")(b, ALPHA, BETA, c)
        want = tx.SpmmPlan(port, 16, backend, device="cpu")(b, ALPHA, BETA, c)
        assert torch.equal(got, want), backend


# (format, the port's backend, the JAX side: "serve" runs its ServePlan on
# that backend, else its SpmmPlan on the JAX-bucketized pack)
SERVE_CASES = [
    ("vpu", "pallas", "serve", "xla"),
    ("vpu", "xla", "serve", "xla"),
    ("mxu", "mxu", "plan", "mxu_interpret"),
    ("edge", "edge", "plan", "edge_interpret"),
    ("ell", "ell", "serve", "ell"),
]


@pytest.mark.parametrize("n", [16, 40])
@pytest.mark.parametrize("fmt,backend,how,jax_backend", SERVE_CASES)
def test_serve_plan_matches_jax_and_unbucketed_plan(fmt, backend, how, jax_backend, n):
    port, ref = _pair(fmt)
    bucketed, ref_bucketed = bucketize_pack(port), ref_bucketize(ref)
    b, c = _operands(port.m, port.k, n)
    plan = tx.ServePlan(bucketed, n, backend, device="cpu")
    got = plan(b, ALPHA, BETA, c)
    assert got.shape == (port.m, n) and got.device.type == "cpu"
    assert torch.equal(got, tx.SpmmPlan(port, n, backend, device="cpu")(b, ALPHA, BETA, c))
    if how == "serve":
        want = RefServePlan(ref_bucketed, n, jax_backend, tile_n=128)(b, ALPHA, BETA, c)
    else:
        want = np.asarray(RefPlan(ref_bucketed, n, backend=jax_backend)(b, ALPHA, BETA, c))
    assert np.abs(got.numpy() - want).max() <= _tol(want)
    # the bucket-shaped call: the padded output, its first m rows the product
    b_p = torch.zeros((plan.k_padded, n))
    b_p[: port.k] = torch.from_numpy(b)
    c_p = torch.zeros((plan.m_padded, n))
    c_p[: port.m] = torch.from_numpy(c)
    out = plan.call_padded(b_p, c_p, ALPHA, BETA)
    assert out.shape == (plan.m_padded, n) and torch.equal(out[: port.m], got)


SERVER_CASES = {"vpu": ((190, 280, 2400), (185, 295, 2500)),
                "mxu": ((190, 280, 2400), (192, 285, 2450)),
                "edge": ((190, 280, 2400), (187, 290, 2450)),
                "ell": ((180, 280, 540), (183, 285, 549))}


@pytest.mark.parametrize("fmt", sorted(SERVER_CASES))
def test_server_serves_two_matrices_in_one_bucket(fmt):
    kw = {**CFGS[fmt], "ell_r": 4} if fmt == "ell" else CFGS[fmt]
    cfg, ref_cfg = tx.SpmmConfig(**kw), RefConfig(**kw)
    server = tx.SpmmServer(16, config=cfg, fmt=fmt, device="cpu")
    assert server.backend == {"vpu": "pallas", "mxu": "mxu", "edge": "edge", "ell": "ell"}[fmt]
    # its kernel backend: only the signature is read, no product
    ref_server = RefServer(16, config=ref_cfg, fmt=fmt, backend="xla" if fmt == "vpu" else fmt)
    news = []
    for seed, (m, k, nnz) in enumerate(SERVER_CASES[fmt]):
        args = _lin_coo(m, k, nnz, seed + 2)
        coo = tx.COOMatrix(*args)
        plan = server.plan(coo)
        news.append(plan.bucket_new)
        b, c = _operands(m, k, 16, seed=seed)
        got = plan(b, ALPHA, BETA, c)
        unbucketed = PACKERS[fmt][0](coo, cfg)
        assert torch.equal(got, tx.SpmmPlan(unbucketed, 16, server.backend,
                                            device="cpu")(b, ALPHA, BETA, c))
        exact = tx.golden_spmm_exact(tx.CSRMatrix.from_coo(coo), b, ALPHA, BETA, c)
        assert tx.verify(exact, got.numpy()).passed
        assert np.abs(got.numpy() - exact).max() <= _tol(exact)
        # the same bucket as the JAX server's, tile_n and the backend aside
        ref_packed = PACKERS[fmt][1](RefCOO(*args), ref_cfg,
                                     **({} if fmt == "ell" else dict(impl="numpy")))
        ref_sig = ref_server.bucket_signature(ref_bucketize(ref_packed))
        assert server.bucket_signature(plan.packed)[:-1] == ref_sig[:-2]
    assert news == [True, False]


def test_server_ell_hub_rows_fold_with_bucket_padding():
    """Hub rows at R = 2: the real-row region and the virtual rows are
    bucket-padded, and the pad folds (0.0 into the last real fold target)
    change no bit."""
    port, _ = _pair("ell")
    coo = tx.COOMatrix(*_hub_coo())
    server = tx.SpmmServer(16, config=port.config, fmt="ell", device="cpu")
    plan = server.plan(coo)
    assert plan.packed.n_virt > port.n_virt > 0 and plan.packed.m_base > port.m_base
    assert np.all(np.diff(plan.packed.fold_rows) >= 0)
    b, c = _operands(*coo.shape, 16, seed=5)
    got = plan(b, ALPHA, BETA, c)
    assert torch.equal(got, tx.SpmmPlan(port, 16, "ell", device="cpu")(b, ALPHA, BETA, c))
    exact = tx.golden_spmm_exact(tx.CSRMatrix.from_coo(coo), b, ALPHA, BETA, c)
    assert np.abs(got.numpy() - exact).max() <= _tol(exact)


def test_server_no_c_path_and_errors_match_jax():
    cfg = tx.SpmmConfig(**CFGS["vpu"])
    with pytest.raises(ValueError, match="formats"):
        tx.SpmmServer(16, config=cfg, fmt="bogus", device="cpu")
    with pytest.raises(ValueError):
        RefServer(16, config=RefConfig(**CFGS["vpu"]), fmt="bogus")
    with pytest.raises(ValueError, match="not servable"):
        tx.SpmmServer(16, config=cfg, fmt="ell", backend="ell_pallas", device="cpu")
    with pytest.raises(ValueError):
        RefServer(16, config=RefConfig(ell_r=4), fmt="ell", backend="ell_pallas")
    with pytest.raises(ValueError, match="does not run"):
        tx.SpmmServer(16, config=cfg, fmt="vpu", backend="edge", device="cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        tx.SpmmServer(16, config=cfg, fmt="vpu", backend="pallas_interpret", device="cpu")
    assert tx.SpmmServer(16, config=cfg, fmt="ell", device="cpu").backend == "ell"
    server = tx.SpmmServer(16, config=cfg, backend="xla", device="cpu")
    coo = tx.COOMatrix(*_lin_coo(100, 120, 800, 6))
    plan = server.plan(coo)
    b, _ = _operands(100, 120, 16, seed=7)
    got = plan(b, 2.0)
    exact = tx.golden_spmm_exact(tx.CSRMatrix.from_coo(coo), b, 2.0, 0.0, None)
    assert np.abs(got.numpy() - exact).max() <= _tol(exact)
    with pytest.raises(ValueError, match="B must be"):
        plan(b[:50])
    with pytest.raises(ValueError, match="C must be"):
        plan(b, 1.0, 1.0, np.zeros((99, 16), np.float32))
    with pytest.raises(ValueError, match="requires an input C"):
        plan(b, 1.0, 1.0, None)


@pytest.mark.parametrize("fmt", ["vpu", "mxu", "edge"])
def test_serve_plan_rejects_reordered_pack(fmt):
    """A degree-reordered pack needs SpmmPlan's B[col_perm] / C[row_perm];
    ServePlan refuses it with the JAX message, and bucket padding keeps the
    permutation record."""
    port_pack, _ = PACKERS[fmt]
    packed = port_pack(tx.COOMatrix(*_lin_coo(96, 512, 600, 31)),
                       tx.SpmmConfig(**CFGS[fmt]), reorder_cols=True)
    bucketed = bucketize_pack(packed)
    assert bucketed.col_perm is not None
    with pytest.raises(ValueError, match="reordered"):
        tx.ServePlan(bucketed, 16, {"vpu": "xla"}.get(fmt, fmt), device="cpu")


def test_server_through_pack_cache_keeps_one_upload(tmp_path):
    cfg = tx.SpmmConfig(**CFGS["mxu"])
    coo = tx.COOMatrix(*_lin_coo(190, 280, 2400, 2))
    cache = tx.PackCache(root=tmp_path)
    server = tx.SpmmServer(40, config=cfg, fmt="mxu", pack_cache=cache, device="cpu")
    p1, p2 = server.plan(coo, "a"), server.plan(coo, "a")
    assert cache.misses == 1 and cache.hits == 1
    assert p1.packed is p2.packed and p1.arrays[0] is p2.arrays[0]  # one upload
    assert p1.bucket_new and not p2.bucket_new
    # a fresh cache on the same root serves the pack from disk, to the bit
    fresh = tx.SpmmServer(40, config=cfg, fmt="mxu", pack_cache=tx.PackCache(root=tmp_path),
                          device="cpu")
    p3 = fresh.plan(coo, "a")
    assert fresh.pack_cache.disk_hits == 1 and fresh.pack_cache.misses == 0
    b, c = _operands(190, 280, 40)
    assert torch.equal(p3(b, ALPHA, BETA, c), p1(b, ALPHA, BETA, c))
    # a precise server on the same cached pack: the plain one's upload and scans
    precise = tx.SpmmServer(40, config=cfg.with_(precise=1), fmt="mxu", pack_cache=cache,
                            device="cpu").plan(coo, "a")
    assert precise.packed.config.precise == 1 and cache.misses == 1
    assert precise.arrays[0] is p1.arrays[0] and precise.ranges is p1.ranges
    unbucketed = tx.SpmmPlan(tx.pack_mxu(coo, cfg.with_(precise=1)), 40, "mxu", device="cpu")
    assert torch.equal(precise(b, ALPHA, BETA, c), unbucketed(b, ALPHA, BETA, c))


@pytest.mark.parametrize("precise", [0, 1])
@pytest.mark.parametrize("poison", [None, np.nan])
def test_ell_plans_fold_a_buckets_pad_rows_once(poison, precise):
    """The bucket's pad virtual rows (all zero, one target) fold once: the
    plan uploads ``fold_rows`` up to ``ell_fold_count``, and both ELL
    engines give the bits of the full fold table, NaN from B[0] included."""
    port, _ = _pair("ell")
    port = dataclasses.replace(port, config=port.config.with_(precise=precise))
    served = bucketize_pack(port)
    assert ell_fold_count(port) == port.n_virt and ell_fold_count(served) == port.n_virt + 1
    b, c = _operands(port.m, port.k, 16, seed=9)
    if poison is not None:
        b[0] = poison
    b_p = torch.from_numpy(np.concatenate([b, np.zeros((served.k_bucket - port.k, 16),
                                                       np.float32)]))
    c_p = torch.zeros((served.m_padded, 16))
    c_p[: port.m] = torch.from_numpy(c)
    arrays = [torch.from_numpy(a) for a in (served.vals, served.cols, served.fold_rows)]
    for backend, full in (("ell", spmm_ell_padded_ref), ("ell_pallas", spmm_ell_gather_padded_ref)):
        plan = tx.ServePlan(served, 16, "ell", device="cpu") if backend == "ell" else \
            tx.SpmmPlan(served, 16, backend, device="cpu")
        assert plan.arrays[2].numel() == port.n_virt + 1
        got = plan(b, ALPHA, BETA, c)
        want = full(*arrays, b_p[: plan.k_padded], c_p, ALPHA, BETA, m_base=served.m_base,
                    precise=precise)[: port.m]
        assert torch.equal(got.nan_to_num(), want.nan_to_num()), backend
        assert torch.equal(got.isnan(), want.isnan()), backend
        # the ell engine multiplies pad slots (0 * B[0]); ell_pallas selects them out
        assert bool(got.isnan().any()) == (poison is not None and backend == "ell")
        if poison is None:  # a NaN B[0] meets the bucket's pad slots too (0 * NaN)
            unbucketed = tx.SpmmPlan(port, 16, backend, device="cpu")(b, ALPHA, BETA, c)
            assert torch.equal(got, unbucketed), backend
