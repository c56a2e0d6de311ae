"""The plan's slab route at the operands' real size, on the CPU.

``SpmmPlan.__call__`` on the ``mxu`` route hands the kernel (K1, or K2 for
N <= 32; on the CPU their plain version, ``spmm_slab_padded_ref``) the
caller's (K, N) B and (M, N) C where they lie and takes back a fresh (M, N)
output: no pad of B to whole K-windows, none of C to whole M-tiles, no
slice. Held here to the padded route (``pad_b``, ``pad_c``, the padded
plain version, ``unpad``) to the bit at every precise level, on a matrix
whose K is a multiple of neither block_k nor window_k and whose M is not a
multiple of 128, with the counters ``plan.in_place`` and
``plan.pad_bytes``; a reordered pack still counts its gathers; the value
op's forward and gradients are the padded route's bits; a matrix of no
rows or no columns goes in place too; ``ServePlan`` and
``repeat`` still take padded operands; ``slab_edges`` lists the slabs whose
CTAs meet an edge.
"""

import torch_cpu  # noqa: F401  one torch thread per xdist worker

import numpy as np
import pytest
import torch

import sextans_tpu_torch as tx
from sextans_tpu_torch.ops.spmm_slab import (
    MSLAB,
    slab_edges,
    slab_in_place,
    slab_visits,
    spmm_slab_padded_ref,
)
from sextans_tpu_torch.utils import profiling

ALPHA, BETA = 0.85, -2.06
M, K = 300, 250  # 250 = 7 * 32 + 26 = 128 + 122; 300 = 2 * 128 + 44


def _coo(seed=3):
    return tx.COOMatrix.random(M, K, 3000, seed=seed, banded=True, bandwidth=60)


def _cfg(precise=0):
    # m_padded 512: slab 2 holds the last 44 real rows, slab 3 none
    return tx.SpmmConfig(tile_m=256, window_k=128, block_k=32, group_blocks=4,
                         precise=precise)


def _operands(n, seed=0):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.standard_normal((K, n)).astype(np.float32)),
            torch.from_numpy(rng.standard_normal((M, n)).astype(np.float32)))


def _padded_route(pl, b, c, alpha=ALPHA, beta=BETA):
    """The padded route: B and C padded, the padded plain version, the slice."""
    cfg = pl.packed.config
    c_p = pl.no_c() if c is None else pl.pad_c(c)
    out = spmm_slab_padded_ref(*pl.arrays, pl.pad_b(b), c_p, alpha, 0.0 if c is None else beta,
                               tile_m=cfg.tile_m, window_k=cfg.window_k, block_k=cfg.block_k,
                               group_blocks=cfg.group_blocks, with_c=c is not None,
                               precise=cfg.precise)
    assert out.shape == (pl.packed.m_padded, pl.n)
    return pl.unpad(out)


@pytest.mark.parametrize("n", [24, 40])
@pytest.mark.parametrize("precise", [0, 1, 2])
@pytest.mark.parametrize("with_c", [True, False])
def test_in_place_call_equals_the_padded_route(with_c, precise, n):
    packed = tx.pack_mxu(_coo(), _cfg(precise))
    assert packed.k_padded > K and packed.m_padded - M > 128 and slab_in_place(packed)
    pl = tx.plan(packed, n, "mxu", device="cpu")
    assert (pl._b_rows, pl._c_rows) == (K, M)
    b, c = _operands(n)
    b0, c0 = b.clone(), c.clone()
    got = pl(b, ALPHA, BETA, c) if with_c else pl(b, ALPHA)
    assert tuple(got.shape) == (M, n) and got._base is None
    assert torch.equal(got, _padded_route(pl, b, c if with_c else None))
    assert torch.equal(b, b0) and torch.equal(c, c0)  # the caller's operands, read only


@pytest.mark.parametrize("with_c", [True, False])
@pytest.mark.parametrize("cut", [0, 1, 26, 100])
def test_plain_version_reads_past_bs_rows_as_zeros(cut, with_c):
    """B of ``K - cut`` rows reads as that B with zero rows to k_padded, and
    C of M rows gives M rows, each the padded call's, whole blocks past B's
    end (cut 100) included."""
    packed = tx.pack_mxu(_coo(), _cfg())
    pl = tx.plan(packed, 40, "mxu", device="cpu")
    b, c = _operands(40, seed=1)
    b = b[: K - cut]
    zeros = torch.cat([b, torch.zeros(packed.k_padded - b.shape[0], 40)])
    cfg = packed.config
    kw = dict(tile_m=cfg.tile_m, window_k=cfg.window_k, block_k=cfg.block_k,
              group_blocks=cfg.group_blocks, with_c=with_c, m=M, k=K - cut)
    c_m = c if with_c else pl.no_c(M)
    c_p = pl.pad_c(c) if with_c else pl.no_c()
    got = spmm_slab_padded_ref(*pl.arrays, b, c_m, ALPHA, BETA, **kw)
    want = spmm_slab_padded_ref(*pl.arrays, zeros, c_p, ALPHA, BETA, **kw)
    assert got.shape == (M, 40) and torch.equal(got, want[:M])


@pytest.mark.parametrize("n", [24, 40])
@pytest.mark.parametrize("shape", [(M, 0), (0, K), (0, 0)])
def test_empty_matrix_goes_in_place(shape, n):
    """A matrix of no rows or no columns takes the in-place route too: its
    output has M rows, the padded route's bits (beta * C where K is 0)."""
    coo = tx.COOMatrix(shape, [], [], [])
    pl = tx.plan(tx.pack_mxu(coo, _cfg()), n, "mxu", device="cpu")
    assert pl._in_place and (pl._c_rows, pl._b_rows) == shape
    rng = np.random.default_rng(n)
    b = torch.from_numpy(rng.standard_normal((shape[1], n)).astype(np.float32))
    c = torch.from_numpy(rng.standard_normal((shape[0], n)).astype(np.float32))
    got = pl(b, ALPHA, BETA, c)
    assert tuple(got.shape) == (shape[0], n) and torch.equal(got, _padded_route(pl, b, c))


def test_in_place_counters_and_no_pad_bytes(monkeypatch):
    pl = tx.plan(tx.pack_mxu(_coo(), _cfg()), 40, "mxu", device="cpu")
    b, c = _operands(40)
    monkeypatch.setattr(profiling, "_COUNTERS", {})
    for _ in range(3):
        pl(b, ALPHA, BETA, c)
    for _ in range(2):
        pl(b, ALPHA)
    got = tx.counters()
    assert (got["plan.calls"], got["plan.in_place"], got["plan.pad_bytes"]) == (5, 5, 0)
    assert pl.pad_b(b, pl.k) is b and pl.pad_c(c, pl.m) is c


def test_in_place_call_on_a_reordered_pack(monkeypatch):
    """A pack with its rows and columns reordered: B and C are gathered, not
    padded, and the gathers are counted in ``plan.pad_bytes``."""
    n = 40
    packed = tx.pack_mxu(_coo(), _cfg(), reorder_cols=True, reorder_rows_=True)
    assert packed.col_perm is not None and packed.row_perm is not None
    pl = tx.plan(packed, n, "mxu", device="cpu")
    b, c = _operands(n, seed=2)
    monkeypatch.setattr(profiling, "_COUNTERS", {})
    got = pl(b, ALPHA, BETA, c)
    pl(b, ALPHA)
    assert tx.counters() == {"plan.calls": 2, "plan.in_place": 2,
                             "plan.pad_bytes": 4 * n * (2 * K + M)}
    assert torch.equal(got, _padded_route(pl, b, c))


@pytest.mark.parametrize("n", [24, 40])
def test_value_op_forward_and_gradients_are_the_padded_routes(n):
    """The value op hands its plans B (forward) and g (A^T's product) at
    their rows: the output and every gradient are the bits of the padded
    route, which pads B and g and slices the products."""
    coo = _coo(seed=5)
    op = tx.spmm_value_op(coo, n, config=_cfg(), fmt="mxu", device="cpu")
    fwd, bwd = op.fwd_plan, op.bwd_plan
    assert fwd._in_place and bwd._in_place
    rng = np.random.default_rng(n)
    vals = torch.as_tensor(coo.vals, dtype=torch.float32).requires_grad_()
    b = torch.from_numpy(rng.standard_normal((K, n)).astype(np.float32)).requires_grad_()
    c = torch.from_numpy(rng.standard_normal((M, n)).astype(np.float32)).requires_grad_()
    g = torch.from_numpy(rng.standard_normal((M, n)).astype(np.float32))
    alpha = torch.tensor(ALPHA, requires_grad=True)
    beta = torch.tensor(BETA, requires_grad=True)
    out = op(vals, b, c, alpha, beta)
    out.backward(g)

    def padded(plan, pv, x):
        return plan.unpad(plan.run_values(pv, plan.pad_b(x), plan.no_c(), 1.0, 0.0,
                                          with_c=False))

    v = vals.detach()
    ab = padded(fwd, op.scatter(v), b.detach())
    assert torch.equal(out.detach(), alpha.detach() * ab + beta.detach() * c.detach())
    assert torch.equal(b.grad, alpha.detach() * padded(bwd, op.scatter_t(v), g))
    assert torch.equal(vals.grad, alpha.detach() * op.sddmm(g, b.detach()))
    assert torch.equal(c.grad, beta.detach() * g)
    assert torch.equal(alpha.grad, torch.dot(g.reshape(-1), ab.reshape(-1)))
    assert torch.equal(beta.grad, torch.dot(g.reshape(-1), c.detach().reshape(-1)))


@pytest.mark.parametrize("n", [24, 40])
def test_serve_plan_and_repeat_take_padded_operands(n):
    """``ServePlan.call_padded`` takes bucket-shaped B and C and returns the
    bucket's rows, whose real ones are the in-place call's; ``repeat``
    carries the padded C."""
    packed = tx.pack_mxu(_coo(), _cfg())
    b, c = _operands(n, seed=4)
    pl = tx.plan(packed, n, "mxu", device="cpu")
    once = pl(b, ALPHA, BETA, c)
    served = tx.ServePlan(tx.bucketize_pack(packed), n, "mxu", device="cpu")
    assert served._in_place
    out = served.call_padded(served.pad_b(b), served.pad_c(c), ALPHA, BETA)
    assert out.shape == (served.packed.m_padded, n)
    assert torch.equal(out[:M], once) and torch.equal(served(b, ALPHA, BETA, c), once)
    assert torch.equal(pl.repeat(b, ALPHA, BETA, c, times=2), pl(b, ALPHA, BETA, once))


@pytest.mark.parametrize("m,k,want", [
    (M, K, "partial"),  # slab 2 holds rows past M, slab 3 is wholly past; blocks pass K
    (512, 256, "none"),  # the padded shapes: no edge at all
    (512, K - 100, "k"),  # blocks wholly past B's end too
])
def test_slab_edges_are_the_slabs_that_meet_an_edge(m, k, want):
    """Against each block's slab and rows worked out from the pack itself:
    a slab is listed where it holds a row at or past m, or a listed block
    that reads a row at or past k."""
    packed = tx.pack_mxu(_coo(), _cfg())
    cfg = packed.config
    scan = slab_visits(packed)
    ranges = tuple(torch.as_tensor(a) for a in scan)
    got = slab_edges(ranges, m, k, cfg.block_k)
    assert got.dtype == torch.int32 and got.tolist() == sorted(set(got.tolist()))
    ng, G = packed.n_groups, cfg.group_blocks
    slab = (packed.group_mtile[:ng, None] * (cfg.tile_m // MSLAB) + packed.qm).reshape(-1)
    first = (packed.group_kwin[:, None] * cfg.window_k + packed.bcol).reshape(-1)
    listed = scan[1][: scan[0][-1]]  # the blocks the slabs list (parked ones are not)
    n_slabs = packed.m_padded // MSLAB
    want_set = {s for s in range(n_slabs) if (s + 1) * MSLAB > m}
    want_set |= {int(slab[i]) for i in listed if first[i] + cfg.block_k > k}
    assert got.tolist() == sorted(want_set)
    assert bool(want_set) == (want != "none")
    if want == "partial":
        assert {2, 3} <= want_set
