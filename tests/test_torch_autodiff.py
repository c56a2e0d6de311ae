"""The port's differentiable SpMM (ops/autodiff.py) against the JAX package's.

The same inputs, made with numpy seeds, go through
``sextans_tpu.ops.autodiff.spmm_value_op`` (its ``xla``, ``ell`` and
``*_interpret`` backends, as its own tests run it on the CPU) and the port's
``spmm_value_op(device="cpu")``, whose kernel wrappers run their plain
versions. Tolerances, in ulp of the JAX value's max|.|: the forward, dB
and dvals within 4 (both sum f32 products in another order: the kernels'
plain versions against XLA, a product and a sum against ``einsum``); dC
equal (beta * G on both sides); dalpha and dbeta within 2^-20 of
sum|G * AB| (sum|G * C|), an f32 dot product of M * N terms in another
order. Then the JAX package's own checks (dense, f64 and finite
differences), and the host scans of a plan over values given at call time.
"""

import torch_cpu  # noqa: F401  one torch thread per xdist worker

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sextans_tpu_torch as tx
from sextans_tpu.format.coo import COOMatrix as RefCOO
from sextans_tpu.ops.autodiff import spmm_value_op as ref_value_op
from sextans_tpu.utils.config import SpmmConfig as RefConfig
from sextans_tpu_torch.ops.autodiff import structure_mask
from sextans_tpu_torch.ops.plan import FORMATS, SpmmPlan
from sextans_tpu_torch.ops.spmm_block import stripe_visits
from sextans_tpu_torch.ops.spmm_ell import ell_fold_count
from sextans_tpu_torch.ops.spmm_slab import slab_visits

ALPHA, BETA = 1.3, -0.7
VPU = dict(tile_m=32, window_k=128, block_k=8, group_blocks=16, tile_n=128)
MXU = dict(tile_m=128, window_k=128, block_k=8, group_blocks=4, tile_n=128)
EDGE = dict(tile_m=64, window_k=128, edge_chunk=128, edge_lanes=2, tile_n=128)
ELL = dict(tile_m=32, ell_r=4)

# (format, config, N, JAX backend)
CASES = [
    ("vpu", VPU, 16, "xla"),
    ("vpu", VPU, 16, "pallas_interpret"),
    ("vpu", dict(VPU, precise=1), 16, "pallas_interpret"),
    ("mxu", MXU, 16, "mxu_interpret"),
    ("mxu", MXU, 40, "mxu_interpret"),
    ("edge", EDGE, 16, "edge_interpret"),
    ("ell", ELL, 16, "ell"),
    ("ell", ELL, 16, "ell_pallas_interpret"),
]


def _setup(m=60, k=80, n=16, nnz=500, seed=3):
    ref = RefCOO.random(m, k, nnz, seed=seed)
    rng = np.random.default_rng(seed + 1)
    b = rng.standard_normal((k, n)).astype(np.float32)
    c = rng.standard_normal((m, n)).astype(np.float32)
    return tx.COOMatrix(ref.shape, ref.rows, ref.cols, ref.vals), ref, b, c


def _dense_of(coo, vals):
    d = np.zeros(coo.shape, dtype=np.float64)
    np.add.at(d, (coo.rows, coo.cols), np.asarray(vals, dtype=np.float64))
    return d


def _port_grads(op, vals, b, c, g, alpha=ALPHA, beta=BETA):
    """The port op's output and its five gradients for cotangent ``g``."""
    args = [torch.tensor(x, requires_grad=True) for x in (vals, b, c)]
    args += [torch.tensor(x, dtype=torch.float32, requires_grad=True) for x in (alpha, beta)]
    out = op(*args)
    out.backward(torch.as_tensor(g))
    return out.detach().numpy(), [a.grad.numpy() for a in args]


def _ulp(x):
    return float(np.spacing(np.float32(np.abs(x).max())))


@pytest.mark.parametrize("fmt,kw,n,backend", CASES)
def test_value_op_matches_jax(fmt, kw, n, backend):
    port, ref, b, c = _setup(n=n, seed=21)
    g = np.random.default_rng(5).standard_normal((60, n)).astype(np.float32)
    op = tx.spmm_value_op(port, n, config=tx.SpmmConfig(**kw), fmt=fmt, device="cpu")
    out, (dvals, db, dc, dalpha, dbeta) = _port_grads(op, port.vals, b, c, g)

    jop = ref_value_op(ref, n, backend=backend, config=RefConfig(**kw), fmt=fmt)
    j_out, vjp = jax.vjp(jop, jnp.asarray(ref.vals), jnp.asarray(b), jnp.asarray(c),
                         jnp.float32(ALPHA), jnp.float32(BETA))
    j_dvals, j_db, j_dc, j_dalpha, j_dbeta = (np.asarray(x) for x in vjp(jnp.asarray(g)))

    for got, want in ((out, np.asarray(j_out)), (db, j_db), (dvals, j_dvals)):
        assert got.shape == want.shape and np.isfinite(got).all()
        assert np.abs(got - want).max() <= 4 * _ulp(want)
    assert np.array_equal(dc, j_dc)
    ab = _dense_of(port, port.vals) @ b.astype(np.float64)
    g64 = g.astype(np.float64)
    assert abs(float(dalpha) - float(j_dalpha)) <= 2.0**-20 * np.abs(g64 * ab).sum()
    assert abs(float(dbeta) - float(j_dbeta)) <= 2.0**-20 * np.abs(g64 * c).sum()
    # the transpose pack runs the forward plan's kernel family
    assert op.bwd_plan.backend == op.fwd_plan.backend


@pytest.mark.parametrize("fmt,kw", [("vpu", VPU), ("mxu", MXU), ("edge", EDGE), ("ell", ELL)])
def test_value_op_all_grads(fmt, kw):
    """tests/test_autodiff.py's check: each gradient against dense f64."""
    port, _, b, c = _setup(seed=21)
    g = np.random.default_rng(5).standard_normal((60, 16)).astype(np.float32)
    op = tx.spmm_value_op(port, 16, config=tx.SpmmConfig(**kw), fmt=fmt, device="cpu")
    out, (dvals, db, dc, dalpha, dbeta) = _port_grads(op, port.vals, b, c, g)
    dense = _dense_of(port, port.vals)
    g64, b64 = g.astype(np.float64), b.astype(np.float64)
    assert np.max(np.abs(out - (ALPHA * dense @ b64 + BETA * c.astype(np.float64)))) < 1e-3
    assert np.max(np.abs(db - ALPHA * dense.T @ g64)) < 1e-3
    assert np.max(np.abs(dc - BETA * g64)) < 1e-5
    want_dvals = ALPHA * np.einsum("en,en->e", g64[port.rows], b64[port.cols])
    assert np.max(np.abs(dvals - want_dvals)) < 1e-3
    assert abs(float(dalpha) - float(np.vdot(g64, dense @ b64))) < 1e-2
    assert abs(float(dbeta) - float(np.vdot(g64, c.astype(np.float64)))) < 1e-2


def test_forward_matches_dense():
    port, _, b, c = _setup()
    op = tx.spmm_op(port, 16, 0.85, -2.06, backend="xla", config=tx.SpmmConfig(**VPU),
                    device="cpu")
    want = 0.85 * port.to_dense().astype(np.float64) @ b + (-2.06) * c
    got = op(torch.as_tensor(b), torch.as_tensor(c)).numpy()
    assert np.max(np.abs(got - want)) < 1e-4


def test_grad_wrt_b_is_alpha_at_g():
    """``spmm_op``'s vjp: dB = alpha A^T G, dC = beta G."""
    port, _, b, c = _setup(seed=7)
    alpha, beta = 1.7, 0.3
    op = tx.spmm_op(port, 16, alpha, beta, backend="xla", config=tx.SpmmConfig(**VPU),
                    device="cpu")
    g = np.random.default_rng(9).standard_normal((60, 16)).astype(np.float32)
    bt, ct = torch.tensor(b, requires_grad=True), torch.tensor(c, requires_grad=True)
    db, dc = torch.autograd.grad(op(bt, ct), (bt, ct), torch.as_tensor(g))
    dense = port.to_dense().astype(np.float64)
    assert np.max(np.abs(db.numpy() - alpha * dense.T @ g.astype(np.float64))) < 1e-4
    assert np.max(np.abs(dc.numpy() - beta * g.astype(np.float64))) < 1e-5


def test_grad_of_scalar_loss():
    port, _, b, c = _setup(seed=11)
    op = tx.spmm_op(port, 16, 1.0, 0.5, backend="xla", config=tx.SpmmConfig(**VPU),
                    device="cpu")
    ct = torch.as_tensor(c)

    def loss(b_):
        return (op(b_, ct) ** 2).sum()

    bt = torch.tensor(b, requires_grad=True)
    (g_auto,) = torch.autograd.grad(loss(bt), bt)
    rng = np.random.default_rng(0)
    for _ in range(4):
        i, j = rng.integers(0, b.shape[0]), rng.integers(0, b.shape[1])
        eps = 1e-2
        bp, bm = b.copy(), b.copy()
        bp[i, j] += eps
        bm[i, j] -= eps
        fd = (loss(torch.as_tensor(bp)) - loss(torch.as_tensor(bm))).item() / (2 * eps)
        assert abs(float(g_auto[i, j]) - fd) < 2e-1 + 0.05 * abs(fd)


def test_value_op_finite_differences():
    """The gradients in vals, alpha and beta against central differences."""
    port, _, b, c = _setup(m=40, k=50, n=8, nnz=200, seed=31)
    cfg = tx.SpmmConfig(tile_m=32, window_k=64, block_k=8, group_blocks=16, tile_n=128)
    op = tx.spmm_value_op(port, 8, backend="xla", config=cfg, device="cpu")
    bt, ct = torch.as_tensor(b), torch.as_tensor(c)

    def loss(vals, alpha, beta):
        return (op(vals, bt, ct, alpha, beta) ** 2).sum()

    v0 = torch.tensor(port.vals, requires_grad=True)
    a0 = torch.tensor(0.9, requires_grad=True)
    b0 = torch.tensor(-0.4, requires_grad=True)
    gv, ga, gb = torch.autograd.grad(loss(v0, a0, b0), (v0, a0, b0))
    eps = 1e-2
    rng = np.random.default_rng(2)
    with torch.no_grad():
        for idx in rng.integers(0, port.nnz, size=4):
            vp, vm = v0.clone(), v0.clone()
            vp[idx] += eps
            vm[idx] -= eps
            fd = (loss(vp, 0.9, -0.4) - loss(vm, 0.9, -0.4)).item() / (2 * eps)
            assert abs(float(gv[idx]) - fd) < 2e-1 + 0.05 * abs(fd)
        fd_a = (loss(v0, 0.9 + eps, -0.4) - loss(v0, 0.9 - eps, -0.4)).item() / (2 * eps)
        assert abs(float(ga) - fd_a) < 2e-1 + 0.01 * abs(fd_a)
        fd_b = (loss(v0, 0.9, -0.4 + eps) - loss(v0, 0.9, -0.4 - eps)).item() / (2 * eps)
        assert abs(float(gb) - fd_b) < 2e-1 + 0.01 * abs(fd_b)


def test_value_op_in_a_training_step():
    """tests/test_autodiff.py's composition check: value_and_grad of a mean
    square through the op, in vals, B and alpha at once; gradients only
    where asked (C and beta take none)."""
    port, _, b, c = _setup(seed=41)
    op = tx.spmm_value_op(port, 16, backend="xla", config=tx.SpmmConfig(**VPU), device="cpu")
    vals = torch.tensor(port.vals, requires_grad=True)
    bt = torch.tensor(b, requires_grad=True)
    alpha = torch.tensor(1.0, requires_grad=True)
    ct = torch.as_tensor(c)
    loss = (op(vals, bt, ct, alpha, 0.1) ** 2).mean()
    gv, gb, ga = torch.autograd.grad(loss, (vals, bt, alpha))
    assert np.isfinite(loss.item())
    assert gv.shape == (port.nnz,) and torch.isfinite(gv).all()
    assert gb.shape == bt.shape and torch.isfinite(gb).all()
    assert ga.shape == () and torch.isfinite(ga)


def test_value_op_checks_its_inputs():
    port, _, b, c = _setup()
    with pytest.raises(ValueError, match="unknown pack format"):
        tx.spmm_value_op(port, 16, fmt="dia", device="cpu")
    with pytest.raises(TypeError):
        tx.spmm_value_op(port, 16)  # device is required
    op = tx.spmm_value_op(port, 16, config=tx.SpmmConfig(**VPU), device="cpu")
    with pytest.raises(ValueError, match="vals must be"):
        op(port.vals[:-1], b, c, 1.0, 0.0)
    with pytest.raises(ValueError, match="B must be"):
        op(port.vals, b[:, :8], c, 1.0, 0.0)
    with pytest.raises(ValueError, match="C must be"):
        op(port.vals, b, c[:-1], 1.0, 0.0)
    # numpy inputs and numbers are taken as they are
    want = op(torch.as_tensor(port.vals), torch.as_tensor(b), torch.as_tensor(c),
              torch.tensor(1.0), torch.tensor(0.5))
    assert torch.equal(op(port.vals, b, c, 1.0, 0.5), want)


# ---- the host scans of a plan over values given at call time ----

def _zero_block_pair(seed=0):
    """One pattern twice: values zero on rows 0-39 (whole blocks, stripes
    and slabs) and on the last row, a hub of 40 duplicates of one column
    (ELL virtual rows that repeat each other at the end of the fold table),
    random elsewhere; and all ones."""
    rng = np.random.default_rng(seed)
    rows = np.concatenate([rng.integers(0, 299, 3000), np.full(40, 299)])
    cols = np.concatenate([rng.integers(0, 260, 3000), np.full(40, 7)])
    vals = rng.standard_normal(rows.size).astype(np.float32)
    vals[(rows < 40) | (rows == 299)] = 0.0
    shape = (300, 260)
    return (tx.COOMatrix(shape, rows, cols, vals),
            tx.COOMatrix(shape, rows, cols, np.ones(rows.size, np.float32)))


SCAN_CASES = [("vpu", dict(tile_m=64, window_k=64, block_k=8, group_blocks=16)),
              ("mxu", dict(tile_m=128, window_k=128, block_k=8, group_blocks=4)),
              ("ell", dict(tile_m=32, ell_r=4))]


@pytest.mark.parametrize("fmt,kw", SCAN_CASES)
def test_value_op_scans_walk_the_structure(fmt, kw):
    """An op built from a COO whose values are zero on whole blocks gets the
    scans of the same pattern with ones, and walks every block, stripe
    visit and virtual row that holds an entry, forward and transposed. A
    plan over the zero values themselves drops some: the kernels K1-K3 and
    K5 would skip those entries on the card, whatever values a call
    scatters there."""
    zero, ones = _zero_block_pair()
    cfg = tx.SpmmConfig(**kw)
    n = 16
    op0 = tx.spmm_value_op(zero, n, config=cfg, fmt=fmt, device="cpu")
    op1 = tx.spmm_value_op(ones, n, config=cfg, fmt=fmt, device="cpu")
    dropped = False
    for coo, plan0, plan1 in ((zero, op0.fwd_plan, op1.fwd_plan),
                              (zero.transpose(), op0.bwd_plan, op1.bwd_plan)):
        packed = plan0.packed
        slots = tx.slot_map(coo, cfg, fmt)
        if fmt == "ell":
            n_fold = plan0.arrays[2].numel()  # the fold rows uploaded
            assert n_fold == plan1.arrays[2].numel() == packed.n_virt
            holds = slots // packed.slots_per_row
            assert (holds < packed.m_base + n_fold).all()
            dropped |= ell_fold_count(packed) < n_fold
            continue
        assert all(torch.equal(r0, r1) for r0, r1 in zip(plan0.ranges, plan1.ranges))
        G, bk = cfg.group_blocks, cfg.block_k
        if fmt == "vpu":
            ptr, visits = (r.numpy() for r in plan0.ranges)
            walked = visits[:ptr[-1]]
            block = (slots // (8 * G * bk)) * G + (slots // bk) % G
            value_scan = stripe_visits(packed)
        else:
            ptr, walked = plan0.ranges[0].numpy(), plan0.ranges[1].numpy()
            walked = walked[:ptr[-1]]
            block = (slots // (G * bk * 128)) * G + (slots // (bk * 128)) % G
            value_scan = slab_visits(packed)
        assert np.isin(block, walked).all()
        dropped |= value_scan[0][-1] < ptr[-1]
    assert dropped


def test_structure_scans_keep_their_own_cache():
    """A plan over a pack's structure and one over its values keep their
    scans apart on the packed object, and the value plan's are as before."""
    zero, _ = _zero_block_pair()
    cfg = tx.SpmmConfig(tile_m=64, window_k=64, block_k=8, group_blocks=16)
    packed = FORMATS["vpu"](zero, cfg)
    by_values = SpmmPlan(packed, 16, device="cpu")
    live = structure_mask(packed, tx.slot_map(zero, cfg, "vpu"))
    by_structure = SpmmPlan(packed, 16, device="cpu", structure=live)
    again = SpmmPlan(packed, 16, device="cpu")
    want = stripe_visits(packed)
    assert np.array_equal(by_values.ranges[0].numpy(), want[0])
    assert again.ranges is by_values.ranges
    assert by_structure.ranges[0][-1] > by_values.ranges[0][-1]
    assert np.array_equal(by_structure.ranges[0].numpy(), stripe_visits(packed, live)[0])
    with pytest.raises(ValueError, match="structure must be"):
        SpmmPlan(packed, 16, device="cpu", structure=live[:1])


def test_run_values_runs_the_plan_on_other_values():
    """``run_values`` on the scattered values of A equals the plan on A, and
    on other values the plan on a pack of those: the same kernel, new
    values."""
    port, _, b, _ = _setup(seed=5)
    cfg = tx.SpmmConfig(**MXU)
    op = tx.spmm_value_op(port, 40, config=cfg, fmt="mxu", device="cpu")
    b = np.random.default_rng(1).standard_normal((80, 40)).astype(np.float32)
    other = np.random.default_rng(2).standard_normal(port.nnz).astype(np.float32)
    for vals in (port.vals, other):
        a = tx.COOMatrix(port.shape, port.rows, port.cols, vals)
        want = SpmmPlan(tx.pack_mxu(a, cfg), 40, device="cpu")(b)
        assert torch.equal(op.ab(torch.as_tensor(vals), torch.as_tensor(b)), want)
