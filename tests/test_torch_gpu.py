"""The CUDA kernels against their plain PyTorch versions, on the card.

Needs a CUDA device and nvcc; skipped without a device. This file imports
no JAX, so on a machine without it run it as::

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py -q

Tolerance: ``max|kernel - plain| <= 4 * spacing(f32(max|plain|))``; both sum
the same f32 products in pack order and differ in the rounding of each
block's product and of the epilogue (the slab kernel K1 in plain mode
contracts in 3xTF32 on the tensor cores: on rows of 2,600 terms it is held
to the f64 oracle instead, no more than 1 ulp past the plain version's own
distance from it). In precise mode the block, edge, ELL and DIA kernels
equal their plain versions to the bit: both take the same roundings in the
same order (``ops/df32.py``, ``csrc/df32.cuh``); so do the DIA kernels (K6,
K7) and the gather probes' kernels (``csrc/gather_probe.cu``) in every mode.
"""

import torch_cpu  # noqa: F401  one torch thread per xdist worker

import functools
import re
import subprocess

import numpy as np
import pytest
import torch

import sextans_tpu_torch as tx
from sextans_tpu_torch.ops import df32
from sextans_tpu_torch.ops.spmm_block import spmm_block_padded, spmm_block_padded_ref
from sextans_tpu_torch.ops.spmm_dia import (
    DiaRuns,
    dia_plan,
    dia_runs,
    spmm_dia,
    spmm_dia_ref,
    spmm_dia_skinny,
)
from sextans_tpu_torch.ops.spmm_edge import spmm_edge_padded, spmm_edge_padded_ref
from sextans_tpu_torch.ops.spmm_ell import spmm_ell_gather_padded, spmm_ell_gather_padded_ref
from sextans_tpu_torch.ops.launch import SharedMemoryError
from sextans_tpu_torch.ops.spmm_slab import (
    SKINNY_STAGES,
    slab_launch,
    slab_visits,
    spmm_slab_padded,
    spmm_slab_padded_ref,
    spmm_slab_skinny_padded,
)
from sextans_tpu_torch.probes import dma_gather, ell_issue
from sextans_tpu_torch.utils.matrices import circuit_like, fem_like, stencil_3d
from sextans_tpu_torch.utils.profiling import counters, launches

pytestmark = pytest.mark.gpu

ALPHA, BETA = 0.85, -2.06


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


def _matrix(kind):
    if kind in ("empty_mtiles", "nonfinite_pads"):
        rng = np.random.default_rng(4)
        rows = rng.integers(0, 100, 3000)
        cols = rng.integers(0, 900, 3000)
        vals = rng.standard_normal(3000).astype(np.float32)
        return tx.COOMatrix((1100, 900), rows, cols, vals)
    if kind == "long_stripe":
        # rows 8-15 dense over 2,600 columns: that stripe (row) has 10-40
        # times the visits (slots) of the median one
        k = 2600
        base = tx.COOMatrix.random(1030, k, 5000, seed=3, banded=True, bandwidth=90)
        rows = np.concatenate([base.rows, np.repeat(np.arange(8, 16), k)])
        cols = np.concatenate([base.cols, np.tile(np.arange(k), 8)])
        vals = np.concatenate([base.vals, np.random.default_rng(2).standard_normal(8 * k)
                               .astype(np.float32)])
        lin, keep = np.unique(rows.astype(np.int64) * k + cols, return_index=True)
        return tx.COOMatrix((1030, k), lin // k, lin % k, vals[keep])
    return tx.COOMatrix.random(1030, 777, 12000, seed=3, banded=True, bandwidth=90)


def _check(kernel, plain, cuda, packed, n, with_c, precise=0, poison=None):
    pl = tx.plan(packed, n, "mxu" if hasattr(packed, "qm") else "pallas", device=cuda)
    rng = np.random.default_rng(n)
    b = pl.pad_b(rng.standard_normal((packed.k, n)).astype(np.float32))
    if poison is not None:  # row 0 of every K-window: the rows pad blocks read
        b[::packed.config.window_k] = poison
    c = pl.pad_c(rng.standard_normal((packed.m, n)).astype(np.float32))
    if not with_c:
        c = torch.zeros(1, device=cuda).expand(packed.m_padded, n)
    cfg = packed.config
    kw = dict(tile_m=cfg.tile_m, window_k=cfg.window_k, block_k=cfg.block_k,
              group_blocks=cfg.group_blocks, with_c=with_c, precise=precise)
    shape = {}
    if kernel is not spmm_block_padded:  # the slab kernels' rows: the padded ones, one grid
        shape = dict(m=packed.m_padded, k=packed.k_padded)
    if kernel is spmm_slab_padded:  # K1's operand tiles, made where the plan uploads
        kw["image"] = pl.image
    before = launches(kernel)
    got = kernel(*pl.arrays, b, c, ALPHA, BETA, ranges=pl.ranges, **shape, **kw)
    kw.pop("image", None)
    want = plain(*pl.arrays, b, c, ALPHA, BETA, **kw)
    torch.cuda.synchronize()
    assert launches(kernel) == before + 1
    assert got.shape == want.shape == (packed.m_padded, n) and got.device == cuda
    finite = torch.isfinite(want)
    assert torch.equal(torch.isfinite(got), finite)
    assert bool(finite.all()) == (poison is None)
    if precise and kernel is spmm_block_padded:
        assert torch.equal(got.nan_to_num(), want.nan_to_num())
    tol = 4 * np.spacing(np.float32(want[finite].abs().max().item()))
    assert (got[finite] - want[finite]).abs().max().item() <= tol


BLOCK_KINDS = ["banded", "empty_mtiles", "long_stripe", "nonfinite_pads"]


@pytest.mark.parametrize("kind", BLOCK_KINDS)
@pytest.mark.parametrize("n", [1, 13, 16, 64, 200, 512])
@pytest.mark.parametrize("bk", [8, 1, 32])
def test_block_kernel_matches_plain(cuda, kind, n, bk):
    cfg = tx.SpmmConfig(tile_m=256, window_k=256, block_k=bk,
                        group_blocks=max(32, 128 // bk))
    _check(spmm_block_padded, spmm_block_padded_ref, cuda,
           tx.pack(_matrix(kind), cfg), n, with_c=n != 13,
           poison=float("inf") if kind == "nonfinite_pads" else None)


@pytest.mark.parametrize("kind", ["banded", "empty_mtiles"])
@pytest.mark.parametrize("n", [33, 64, 130])
@pytest.mark.parametrize("bk", [8, 128])
def test_slab_kernel_matches_plain(cuda, kind, n, bk):
    cfg = tx.SpmmConfig(tile_m=512, window_k=512, block_k=bk, group_blocks=4)
    _check(spmm_slab_padded, spmm_slab_padded_ref, cuda,
           tx.pack_mxu(_matrix(kind), cfg), n, with_c=n != 64)


@pytest.mark.parametrize("kind", ["banded", "empty_mtiles"])
@pytest.mark.parametrize("n", [1, 8, 16, 21, 32])
def test_slab_skinny_kernel_matches_plain(cuda, kind, n):
    cfg = tx.SpmmConfig(tile_m=256, window_k=256, block_k=16, group_blocks=8)
    _check(spmm_slab_skinny_padded, spmm_slab_padded_ref, cuda,
           tx.pack_mxu(_matrix(kind), cfg), n, with_c=n != 8)


def _hub_matrix():
    # rows 5 and 600 hold 300 nonzeros each: at R = 8 they spill into
    # virtual rows that the fold adds back
    rng = np.random.default_rng(5)
    rows = np.concatenate([np.full(300, 5), np.full(300, 600), rng.integers(0, 1030, 4000)])
    cols = rng.integers(0, 777, rows.size)
    vals = rng.standard_normal(rows.size).astype(np.float32)
    return tx.COOMatrix((1030, 777), rows, cols, vals)


def _check_new(kernel, plain, cuda, packed, backend, n, with_c, nonfinite_b=False,
               precise=0, n_launches=1):
    pl = tx.plan(packed, n, backend, device=cuda)
    rng = np.random.default_rng(n)
    b_host = rng.standard_normal((packed.k, n)).astype(np.float32)
    if nonfinite_b:
        b_host[0] = np.inf  # read only by pad slots: A has no column 0
    b = pl.pad_b(b_host)
    c = pl.pad_c(rng.standard_normal((packed.m, n)).astype(np.float32))
    if not with_c:
        c = torch.zeros(1, device=cuda).expand(packed.m_padded, n)
    cfg = packed.config
    if backend == "edge":
        kw = dict(tile_m=cfg.tile_m, window_k=cfg.window_k, edge_chunk=cfg.edge_chunk,
                  masked=cfg.edge_masked, with_c=with_c, precise=precise)
        extra = dict(ranges=pl.ranges)
    else:
        kw = dict(m_base=packed.m_base, with_c=with_c, precise=precise)
        extra = dict(ranges=pl.ranges)
    before = launches(kernel)
    got = kernel(*pl.arrays, b, c, ALPHA, BETA, **kw, **extra)
    want = plain(*pl.arrays, b, c, ALPHA, BETA, **kw)
    torch.cuda.synchronize()
    assert launches(kernel) == before + n_launches
    assert got.shape == want.shape == (packed.m_padded, n) and got.device == cuda
    assert torch.isfinite(got).all() and torch.isfinite(want).all()
    if precise or backend == "ell_pallas":  # K5 takes its plain version's roundings
        assert torch.equal(got, want)
    tol = 4 * np.spacing(np.float32(want.abs().max().item()))
    assert (got - want).abs().max().item() <= tol


@pytest.mark.parametrize("kind", ["banded", "empty_mtiles", "long_stripe"])
@pytest.mark.parametrize("n", [1, 13, 16, 64, 200, 512])
@pytest.mark.parametrize("lanes", [1, 4])
def test_edge_kernel_matches_plain(cuda, kind, n, lanes):
    cfg = tx.SpmmConfig(tile_m=256, window_k=256, edge_chunk=136, edge_lanes=lanes)
    _check_new(spmm_edge_padded, spmm_edge_padded_ref, cuda,
               tx.pack_edge(_matrix(kind), cfg), "edge", n, with_c=n != 13)


@pytest.mark.parametrize("n", [1, 13, 64])
def test_edge_kernel_masked_pads_with_nonfinite_b(cuda, n):
    coo = _matrix("banded")
    keep = coo.cols != 0
    coo = tx.COOMatrix(coo.shape, coo.rows[keep], coo.cols[keep], coo.vals[keep])
    cfg = tx.SpmmConfig(tile_m=128, window_k=512, edge_chunk=64, edge_lanes=4,
                        edge_masked=True)
    _check_new(spmm_edge_padded, spmm_edge_padded_ref, cuda, tx.pack_edge(coo, cfg),
               "edge", n, with_c=True, nonfinite_b=True)


def test_edge_kernel_empty_matrix_gives_beta_c(cuda):
    empty = tx.COOMatrix((300, 200), [], [], [])
    packed = tx.pack_edge(empty, tx.SpmmConfig(tile_m=128, window_k=128, edge_chunk=64))
    c = np.random.default_rng(0).standard_normal((300, 24)).astype(np.float32)
    got = tx.plan(packed, 24, "edge", device=cuda)(np.ones((200, 24), np.float32),
                                                    ALPHA, BETA, c)
    assert torch.equal(got.cpu(), torch.from_numpy(c) * np.float32(BETA))


@pytest.mark.parametrize("kind", ["banded", "empty_mtiles", "hub_rows"])
@pytest.mark.parametrize("n", [1, 13, 64, 200])
def test_ell_kernel_matches_plain(cuda, kind, n):
    coo = _hub_matrix() if kind == "hub_rows" else _matrix(kind)
    packed = tx.pack_ell(coo, tx.SpmmConfig(tile_m=64), slots_per_row=8)
    if kind == "hub_rows":
        assert packed.n_virt > 60
    _check_new(spmm_ell_gather_padded, spmm_ell_gather_padded_ref, cuda, packed,
               "ell_pallas", n, with_c=n != 13)


@pytest.mark.parametrize("n", [13, 64])
def test_ell_kernel_selects_out_pads_with_nonfinite_b(cuda, n):
    coo = _matrix("banded")
    keep = coo.cols != 0
    coo = tx.COOMatrix(coo.shape, coo.rows[keep], coo.cols[keep], coo.vals[keep])
    _check_new(spmm_ell_gather_padded, spmm_ell_gather_padded_ref, cuda,
               tx.pack_ell(coo, tx.SpmmConfig(tile_m=64), slots_per_row=32),
               "ell_pallas", n, with_c=True, nonfinite_b=True)


def _ell_variant(kind, precise=0):
    """ELL packs that K5's scan takes as they are: a hub row longer than a
    tile (R = 4: rows 5 and 600 hold 75 padded rows each, folded by the
    second launch), a row over all 777 columns (25 padded rows in one
    tile), a finite-element matrix whose three dofs a node share a tile
    (group_max 3), every row's slots in reverse (live slots that do not
    ascend), and the virtual rows permuted (``fold_rows`` out of order)."""
    cfg = tx.SpmmConfig(tile_m=64, precise=precise)
    if kind == "long_hub":
        return tx.pack_ell(_hub_matrix(), cfg, slots_per_row=4)
    if kind == "wide_row":
        coo = _hub_matrix()
        rows = np.concatenate([coo.rows, np.full(777, 7)])
        cols = np.concatenate([coo.cols, np.arange(777)])
        vals = np.concatenate([coo.vals, np.linspace(-1, 1, 777, dtype=np.float32) + 0.01])
        return tx.pack_ell(tx.COOMatrix(coo.shape, rows, cols, vals), cfg, slots_per_row=32)
    if kind == "fem":
        return tx.pack_ell(fem_like(900, dofs=3, neighbors=7, bandwidth=90, seed=4), cfg,
                           slots_per_row=16)
    packed = tx.pack_ell(_hub_matrix(), cfg, slots_per_row=8)
    if kind == "reversed_slots":
        packed.cols, packed.vals = packed.cols[:, ::-1].copy(), packed.vals[:, ::-1].copy()
    else:  # permuted_virtual
        m, nv = packed.m_base, packed.n_virt
        perm = np.random.default_rng(7).permutation(nv)
        for name in ("cols", "vals"):
            arr = getattr(packed, name).copy()
            arr[m:m + nv] = arr[m + perm]
            setattr(packed, name, arr)
        packed.fold_rows = packed.fold_rows[perm].copy()
    return packed


ELL_VARIANTS = ["long_hub", "wide_row", "fem", "reversed_slots", "permuted_virtual"]


@pytest.mark.parametrize("precise", [0, 1])
@pytest.mark.parametrize("kind", ELL_VARIANTS)
@pytest.mark.parametrize("n", [13, 16, 64, 200])
def test_ell_kernel_takes_every_pack_to_the_bit(cuda, kind, n, precise):
    packed = _ell_variant(kind, precise)
    if kind == "fem":
        assert tx.plan(packed, n, "ell_pallas", device=cuda).ranges.group_max == 3
    _check_new(spmm_ell_gather_padded, spmm_ell_gather_padded_ref, cuda, packed,
               "ell_pallas", n, with_c=n != 16, precise=precise,
               n_launches=2 if kind == "long_hub" else 1)


def test_ell_kernel_needs_its_tiles_on_card(cuda):
    packed = tx.pack_ell(_hub_matrix(), tx.SpmmConfig(tile_m=64), slots_per_row=8)
    pl = tx.plan(packed, 16, "ell_pallas", device=cuda)
    b = pl.pad_b(np.ones((777, 16), np.float32))
    c = pl.pad_c(np.ones((1030, 16), np.float32))
    with pytest.raises(ValueError, match="ell_tiles"):
        spmm_ell_gather_padded(*pl.arrays, b, c, ALPHA, BETA, m_base=packed.m_base)


def test_ell_repeat_on_card_matches_cpu(cuda):
    packed = tx.pack_ell(_hub_matrix(), tx.SpmmConfig(tile_m=64), slots_per_row=4)
    rng = np.random.default_rng(2)
    b = rng.standard_normal((777, 48)).astype(np.float32)
    c = rng.standard_normal((1030, 48)).astype(np.float32)
    on_card = tx.plan(packed, 48, "ell_pallas", device=cuda).repeat(b, ALPHA, BETA, c, times=3)
    on_cpu = tx.plan(packed, 48, "ell_pallas", device="cpu").repeat(b, ALPHA, BETA, c, times=3)
    tol = 4 * np.spacing(np.float32(on_cpu.abs().max().item()))
    assert (on_card.cpu() - on_cpu).abs().max().item() <= tol


def _ell_in_place_pack(kind, precise):
    """``hub_rows``: R = 8, virtual rows and no long row; ``long_hub``: R = 4,
    two logical rows that outgrow a tile (the second launch folds them)."""
    if kind == "long_hub":
        return _ell_variant("long_hub", precise)
    return tx.pack_ell(_hub_matrix(), tx.SpmmConfig(tile_m=64, precise=precise),
                       slots_per_row=8)


def _off16(t):
    """``t``'s values in a contiguous tensor 4 bytes past a 16-byte boundary,
    as a caller's slice may lie: K5 then takes 4-byte loads (vec 1)."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("precise", [0, 1])
@pytest.mark.parametrize("with_c", [True, False])
@pytest.mark.parametrize("kind", ["hub_rows", "long_hub"])
@pytest.mark.parametrize("n,vec", [(16, 4), (40, 4), (512, 4), (600, 4), (16, 1), (40, 1),
                                   (512, 1), (600, 1)])
def test_ell_in_place_call_equals_the_padded_route(cuda, kind, n, vec, with_c, precise):
    """SpmmPlan's call hands K5 the caller's (K, N) B and (M, N) C where they
    lie and a fresh (M, N) output: equal to the padded route (pad_b, pad_c,
    the padded kernel, unpad), and to K5's plain twin on the same unpadded
    operands, to the bit; one launch a call where no row is long, two where
    the long rows' fold runs (their virtual rows kept in a scratch)."""
    packed = _ell_in_place_pack(kind, precise)
    pl = tx.plan(packed, n, "ell_pallas", device=cuda)
    assert (pl.ranges.long_rows.numel() > 0) == (kind == "long_hub")
    rng = np.random.default_rng(n)
    b = torch.from_numpy(rng.standard_normal((packed.k, n)).astype(np.float32)).to(cuda)
    c = torch.from_numpy(rng.standard_normal((packed.m, n)).astype(np.float32)).to(cuda)
    if vec == 1:
        b, c = _off16(b), _off16(c)
    assert (b.data_ptr() % 16 == 0) == (vec == 4)
    b0, c0 = b.clone(), c.clone()
    before = launches(spmm_ell_gather_padded)
    got = pl(b, ALPHA, BETA, c) if with_c else pl(b, ALPHA)
    torch.cuda.synchronize()
    assert launches(spmm_ell_gather_padded) == before + (2 if kind == "long_hub" else 1)
    assert got.shape == (packed.m, n) and got._base is None and got.device == cuda
    assert torch.isfinite(got).all()
    assert torch.equal(b, b0) and torch.equal(c, c0)
    beta = BETA if with_c else 0.0
    kw = dict(m_base=packed.m_base, with_c=with_c, precise=precise)
    padded = spmm_ell_gather_padded(*pl.arrays, pl.pad_b(b), pl.pad_c(c) if with_c
                                    else pl.no_c(), ALPHA, beta, ranges=pl.ranges, **kw)
    assert padded.shape == (packed.m_padded, n)
    assert torch.equal(got, padded[:packed.m])
    c_in = c.cpu() if with_c else torch.zeros(1).expand(packed.m, n)
    twin = spmm_ell_gather_padded_ref(*(a.cpu() for a in pl.arrays), b.cpu(), c_in, ALPHA,
                                      beta, **kw)
    assert torch.equal(got.cpu(), twin)


@pytest.mark.parametrize("precise", [0, 1])
@pytest.mark.parametrize("kind", ["hub_rows", "long_hub"])
def test_ell_repeat_and_padded_calls_keep_the_padded_rows_on_card(cuda, kind, precise):
    """``repeat`` still carries the whole padded C through K5, virtual rows
    included, to its plain twin's bits; a bucketized pack (a served one,
    ``m_base`` past ``m``) keeps the padded route, and its real rows are the
    in-place call's; a C of fewer rows than the real ones is refused."""
    packed = _ell_in_place_pack(kind, precise)
    n = 40
    pl = tx.plan(packed, n, "ell_pallas", device=cuda)
    rng = np.random.default_rng(3)
    b = rng.standard_normal((packed.k, n)).astype(np.float32)
    c = (0.1 * rng.standard_normal((packed.m, n))).astype(np.float32)
    b_p, c_p = pl.pad_b(b), pl.pad_c(c)
    kw = dict(m_base=packed.m_base, precise=precise)
    carry, twin = c_p, c_p.cpu()
    cpu_arrays = [a.cpu() for a in pl.arrays]
    for _ in range(3):
        carry = spmm_ell_gather_padded(*pl.arrays, b_p, carry, ALPHA, BETA, ranges=pl.ranges,
                                       **kw)
        twin = spmm_ell_gather_padded_ref(*cpu_arrays, b_p.cpu(), twin, ALPHA, BETA, **kw)
    assert carry.shape == (packed.m_padded, n)
    assert torch.equal(carry.cpu(), twin)
    assert torch.equal(pl.repeat(b, ALPHA, BETA, c, times=3), carry[:packed.m])
    served = tx.SpmmPlan(tx.bucketize_pack(packed), n, "ell_pallas", device=cuda)
    assert torch.equal(served(b, ALPHA, BETA, c), pl(b, ALPHA, BETA, c))
    with pytest.raises(ValueError, match="rows"):
        spmm_ell_gather_padded(*pl.arrays, b_p, c_p[:packed.m_base - 1], ALPHA, BETA,
                               ranges=pl.ranges, **kw)


@pytest.mark.parametrize("backend", ["pallas", "mxu", "xla", "edge", "ell", "ell_pallas"])
@pytest.mark.parametrize("n", [16, 96])
def test_plan_on_card_matches_cpu(cuda, backend, n):
    coo = _matrix("banded")
    cfg = tx.SpmmConfig(tile_m=256, window_k=256, block_k=8, group_blocks=16)
    packed = (
        tx.pack_mxu(coo, cfg, reorder_rows_=True) if backend == "mxu"
        else tx.pack_edge(coo, cfg, reorder_cols=True, reorder_rows_=True)
        if backend == "edge"
        else tx.pack_ell(coo, cfg) if backend in ("ell", "ell_pallas")
        else tx.pack(coo, cfg, reorder_cols=True)
    )
    rng = np.random.default_rng(1)
    b = rng.standard_normal((coo.shape[1], n)).astype(np.float32)
    c = rng.standard_normal((coo.shape[0], n)).astype(np.float32)
    on_card = tx.plan(packed, n, backend, device=cuda)
    on_cpu = tx.plan(packed, n, backend, device="cpu")
    exact = tx.golden_spmm_exact(tx.CSRMatrix.from_coo(coo), b, ALPHA, BETA, c)
    tol = 4 * np.spacing(np.float32(np.abs(exact).max()))
    for got in (on_card(b, ALPHA, BETA, c), on_card.repeat(b, ALPHA, BETA, c, times=1)):
        assert got.device == cuda
        got = got.cpu().numpy()
        assert tx.verify(exact, got).passed
        assert np.abs(got - on_cpu(b, ALPHA, BETA, c).numpy()).max() <= tol
    noc = on_card(b, 1.5).cpu().numpy()
    assert np.abs(noc - on_cpu(b, 1.5).numpy()).max() <= tol


def test_wrappers_check_operands(cuda):
    packed = tx.pack(_matrix("banded"), tx.SpmmConfig(tile_m=256, window_k=256,
                                                      group_blocks=16))
    pl = tx.plan(packed, 16, device=cuda)
    b = pl.pad_b(np.ones((packed.k, 16), np.float32))
    c = pl.pad_c(np.ones((packed.m, 16), np.float32))
    kw = dict(tile_m=256, window_k=256, block_k=8, group_blocks=16, ranges=pl.ranges)
    with pytest.raises(ValueError, match="float32"):
        spmm_block_padded(*pl.arrays, b.double(), c, 1.0, 0.0, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        spmm_block_padded(*pl.arrays, b.t().contiguous().t(), c, 1.0, 0.0, **kw)
    with pytest.raises(ValueError, match="expected cuda"):
        spmm_block_padded(*pl.arrays, b.cpu(), c, 1.0, 0.0, **kw)
    # the kernel walks per-stripe visit lists, not the slab kernels' per-slab lists
    slab_lists = tuple(torch.as_tensor(a, device=cuda) for a in slab_visits(
        tx.pack_mxu(_matrix("banded"), tx.SpmmConfig(tile_m=256, window_k=256))))
    with pytest.raises(ValueError, match="stripe_ptr"):
        spmm_block_padded(*pl.arrays, b, c, 1.0, 0.0, **{**kw, "ranges": slab_lists})
    with pytest.raises(ValueError, match="multiple of tile_m"):
        spmm_block_padded(*pl.arrays, b, c[:-8], 1.0, 0.0, **kw)
    with pytest.raises(ValueError, match="c_padded must have shape"):
        spmm_block_padded(*pl.arrays, b, c[:, :8], 1.0, 0.0, **kw)


def _dia_split(kind):
    if kind == "stencil":  # offsets 0, +-1, +-12, +-144: one consecutive run
        return tx.split_structure(stencil_3d(12, seed=1), n=16)
    if kind == "band":  # a +-60 band of consecutive offsets, and hub parts
        return tx.split_structure(circuit_like(3000, seed=2), n=64)
    # rectangular, offsets spread and negative: every B row read is shifted
    rng = np.random.default_rng(7)
    rows = np.concatenate([np.arange(900)] * 3 + [rng.integers(0, 900, 3000)])
    cols = np.concatenate([np.arange(900) + 40, np.arange(900) // 2,
                           np.clip(np.arange(900) - 333, 0, 1199),
                           rng.integers(0, 1200, 3000)])
    return tx.split_structure(tx.COOMatrix((900, 1200), rows, cols,
                                           rng.standard_normal(rows.size)), n=64)


def _runs_cut_at(offsets, cuda, cut):
    """A run plan of ``offsets`` built by hand, with runs of span at most
    ``cut`` (dia_plan cuts at DIA_SPAN_MAX)."""
    offs = np.asarray(offsets, dtype=np.int64)
    ptr = dia_runs(offs, cut)
    return DiaRuns(torch.from_numpy(offs.astype(np.int32)).to(cuda), torch.from_numpy(ptr).to(cuda),
                   int((offs[ptr[1:] - 1] - offs[ptr[:-1]]).max()), int(np.diff(ptr).max()))


def _check_dia(kernel, cuda, split, n, with_c, misaligned=False, precise=0,
               cut=None, poison=None):
    rng = np.random.default_rng(n)
    dv = torch.as_tensor(split.diag_vals, device=cuda)
    offs = torch.as_tensor(split.diag_offsets.astype(np.int32), device=cuda)
    b = torch.as_tensor(rng.standard_normal((split.k, n)).astype(np.float32), device=cuda)
    if poison is not None:
        b[poison] = float("nan")
    if misaligned:  # B one float past a 16-byte boundary: 4-byte loads
        buf = torch.empty(b.numel() + 1, device=cuda)
        buf[1:] = b.reshape(-1)
        b = buf[1:].view(split.k, n)
    c = torch.as_tensor(rng.standard_normal((split.m, n)).astype(np.float32), device=cuda)
    if not with_c:
        c = torch.zeros(1, device=cuda).expand(split.m, n)
    kw = dict(with_c=with_c, precise=precise)
    # K6 and K7 take the offsets their plan holds
    runs = {"runs": (dia_plan(split.diag_offsets, cuda) if cut is None
                     else _runs_cut_at(split.diag_offsets, cuda, cut))}
    offs = runs["runs"].offsets
    before = launches(kernel)
    got = kernel(dv, offs, b, c, ALPHA, BETA, **runs, **kw)
    want = spmm_dia_ref(dv, offs, b, c, ALPHA, BETA, **kw)
    torch.cuda.synchronize()
    assert launches(kernel) == before + 1
    assert got.shape == want.shape == (split.m, n) and got.device == cuda
    finite = torch.isfinite(want)
    assert torch.equal(torch.isfinite(got), finite)
    assert bool(finite.all()) == (poison is None)
    assert torch.equal(got.nan_to_num(), want.nan_to_num())  # K6 and K7, every mode
    tol = 4 * np.spacing(np.float32(want[finite].abs().max().item()))
    assert (got[finite] - want[finite]).abs().max().item() <= tol


@pytest.mark.parametrize("kind", ["stencil", "band", "rect"])
@pytest.mark.parametrize("n", [33, 40, 64, 130, 512])
def test_dia_kernel_matches_plain(cuda, kind, n):
    split = _dia_split(kind)
    assert split.diag_offsets.size >= 5
    _check_dia(spmm_dia, cuda, split, n, with_c=n != 40)


@pytest.mark.parametrize("kind", ["stencil", "band", "rect"])
@pytest.mark.parametrize("n", [1, 8, 13, 16, 32])
def test_dia_skinny_kernel_matches_plain(cuda, kind, n):
    _check_dia(spmm_dia_skinny, cuda, _dia_split(kind), n, with_c=n != 13)


@pytest.mark.parametrize("kernel,n", [(spmm_dia, 64), (spmm_dia_skinny, 16)])
def test_dia_kernels_take_misaligned_b(cuda, kernel, n):
    _check_dia(kernel, cuda, _dia_split("band"), n, with_c=True, misaligned=True)


@pytest.mark.parametrize("n,backend", [(16, "pallas"), (64, "pallas"), (16, "edge"),
                                       (64, "ell_pallas"), (64, "mxu")])
def test_hybrid_plan_on_card_matches_cpu(cuda, n, backend):
    coo = circuit_like(3000, seed=2)
    split = tx.split_structure(coo, n=n, min_head_cols=1, min_head_rows=1)
    cfg = tx.SpmmConfig(tile_m=256, window_k=256, block_k=8, group_blocks=16)
    rng = np.random.default_rng(1)
    b = rng.standard_normal((3000, n)).astype(np.float32)
    c = rng.standard_normal((3000, n)).astype(np.float32)
    on_card = tx.HybridSpmmPlan(split, n, residue_config=cfg, backend=backend, device=cuda)
    on_cpu = tx.HybridSpmmPlan(split, n, residue_config=cfg, backend=backend, device="cpu")
    assert on_card.dia_backend == "pallas" and on_cpu.dia_backend == "xla"
    dia = spmm_dia_skinny if n <= 32 else spmm_dia
    exact = tx.golden_spmm_exact(tx.CSRMatrix.from_coo(coo), b, ALPHA, BETA, c)
    tol = 4 * np.spacing(np.float32(np.abs(exact).max()))
    before = launches(dia)
    for got in (on_card(b, ALPHA, BETA, c), on_card.repeat(b, ALPHA, BETA, c, times=1)):
        assert got.device == cuda
        got = got.cpu().numpy()
        assert tx.verify(exact, got).passed
        assert np.abs(got - on_cpu(b, ALPHA, BETA, c).numpy()).max() <= tol
    assert launches(dia) == before + 2
    noc = on_card(b, 1.5).cpu().numpy()
    assert np.abs(noc - on_cpu(b, 1.5).numpy()).max() <= tol


def test_dia_wrappers_check_operands(cuda):
    split = _dia_split("band")
    dv = torch.as_tensor(split.diag_vals, device=cuda)
    offs = torch.as_tensor(split.diag_offsets.astype(np.int32), device=cuda)
    b = torch.ones((split.k, 16), device=cuda)
    c = torch.ones((split.m, 16), device=cuda)
    for kernel in (spmm_dia, spmm_dia_skinny):
        with pytest.raises(ValueError, match="float32"):
            kernel(dv, offs, b.double(), c, 1.0, 0.0)
        with pytest.raises(ValueError, match="int32"):
            kernel(dv, offs.long(), b, c, 1.0, 0.0)
        with pytest.raises(ValueError, match="contiguous"):
            kernel(dv, offs, b.t().contiguous().t(), c, 1.0, 0.0)
        with pytest.raises(ValueError, match="expected cuda"):
            kernel(dv, offs, b.cpu(), c, 1.0, 0.0)
        with pytest.raises(ValueError, match="offsets must have shape"):
            kernel(dv, offs[:-1], b, c, 1.0, 0.0)
        with pytest.raises(ValueError, match="c must have shape"):
            kernel(dv, offs, b, c[:, :8], 1.0, 0.0)
        with pytest.raises(ValueError, match="c must have shape"):
            kernel(dv, offs, b, c[:-1], 1.0, 0.0, with_c=False)


# ---- precise levels (SpmmConfig.precise = 1, 2) ----

@pytest.mark.parametrize("precise", [1, 2])
@pytest.mark.parametrize("kind", BLOCK_KINDS)
@pytest.mark.parametrize("n,bk", [(1, 8), (13, 8), (16, 4), (64, 8), (200, 32), (512, 8)])
def test_block_kernel_precise_equals_plain(cuda, kind, n, bk, precise):
    cfg = tx.SpmmConfig(tile_m=256, window_k=256, block_k=bk,
                        group_blocks=max(32, 128 // bk), precise=precise)
    _check(spmm_block_padded, spmm_block_padded_ref, cuda,
           tx.pack(_matrix(kind), cfg), n, with_c=n != 13, precise=precise,
           poison=float("nan") if kind == "nonfinite_pads" else None)


@pytest.mark.parametrize("precise", [1, 2])
@pytest.mark.parametrize("kind", ["banded", "empty_mtiles"])
@pytest.mark.parametrize("n", [33, 130])
def test_slab_kernel_precise_matches_plain(cuda, kind, n, precise):
    cfg = tx.SpmmConfig(tile_m=512, window_k=512, block_k=8, group_blocks=4, precise=precise)
    _check(spmm_slab_padded, spmm_slab_padded_ref, cuda,
           tx.pack_mxu(_matrix(kind), cfg), n, with_c=n != 33, precise=precise)


@pytest.mark.parametrize("precise", [1, 2])
@pytest.mark.parametrize("kind", ["banded", "empty_mtiles"])
@pytest.mark.parametrize("n", [8, 21])
def test_slab_skinny_kernel_precise_matches_plain(cuda, kind, n, precise):
    cfg = tx.SpmmConfig(tile_m=256, window_k=256, block_k=16, group_blocks=8, precise=precise)
    _check(spmm_slab_skinny_padded, spmm_slab_padded_ref, cuda,
           tx.pack_mxu(_matrix(kind), cfg), n, with_c=n != 8, precise=precise)


@pytest.mark.parametrize("precise", [1, 2])
@pytest.mark.parametrize("kind", ["banded", "empty_mtiles", "long_stripe"])
@pytest.mark.parametrize("n", [1, 13, 16, 64, 200, 512])
def test_edge_kernel_precise_equals_plain(cuda, kind, n, precise):
    cfg = tx.SpmmConfig(tile_m=256, window_k=256, edge_chunk=136, edge_lanes=4,
                        precise=precise)
    _check_new(spmm_edge_padded, spmm_edge_padded_ref, cuda,
               tx.pack_edge(_matrix(kind), cfg), "edge", n, with_c=n != 13, precise=precise)


@pytest.mark.parametrize("precise", [1, 2])
def test_edge_kernel_precise_masked_pads_with_nonfinite_b(cuda, precise):
    coo = _matrix("banded")
    keep = coo.cols != 0
    coo = tx.COOMatrix(coo.shape, coo.rows[keep], coo.cols[keep], coo.vals[keep])
    cfg = tx.SpmmConfig(tile_m=128, window_k=512, edge_chunk=64, edge_lanes=4,
                        edge_masked=True, precise=precise)
    _check_new(spmm_edge_padded, spmm_edge_padded_ref, cuda, tx.pack_edge(coo, cfg),
               "edge", 40, with_c=True, nonfinite_b=True, precise=precise)


@pytest.mark.parametrize("precise", [1, 2])
def test_edge_kernel_precise_unmasked_pads_with_nonfinite_b(cuda, precise):
    coo = _matrix("banded")
    keep = coo.cols != 0
    coo = tx.COOMatrix(coo.shape, coo.rows[keep], coo.cols[keep], coo.vals[keep])
    cfg = tx.SpmmConfig(tile_m=128, window_k=512, edge_chunk=64, edge_lanes=4,
                        precise=precise)
    packed = tx.pack_edge(coo, cfg)
    pl = tx.plan(packed, 40, "edge", device=cuda)
    rng = np.random.default_rng(3)
    b_host = rng.standard_normal((packed.k, 40)).astype(np.float32)
    b_host[0] = np.inf  # read only by pad slots: A has no column 0
    b, c = pl.pad_b(b_host), pl.pad_c(rng.standard_normal((packed.m, 40)).astype(np.float32))
    kw = dict(tile_m=cfg.tile_m, window_k=cfg.window_k, edge_chunk=cfg.edge_chunk,
              masked=False, precise=precise)
    got = spmm_edge_padded(*pl.arrays, b, c, ALPHA, BETA, ranges=pl.ranges, **kw)
    want = spmm_edge_padded_ref(*pl.arrays, b, c, ALPHA, BETA, **kw)
    torch.cuda.synchronize()
    assert not torch.isfinite(want).all()
    assert torch.equal(torch.isfinite(got), torch.isfinite(want))
    assert torch.equal(got.nan_to_num(), want.nan_to_num())


@pytest.mark.parametrize("precise", [0, 1, 2])
@pytest.mark.parametrize("n", [16, 96])
def test_edge_plan_counts_its_level_and_level_2_is_correctly_rounded(cuda, n, precise):
    """K4 through the plan at each level, with C and without: one
    ``launch.spmm_edge_padded.precise<L>`` a launch at level L and none at
    another; at level 2 every element of this small product is the f32
    nearest to its exact value (none above its own f32 representation
    floor)."""
    coo = fem_like(600, dofs=3, neighbors=5, seed=2)
    cfg = tx.SpmmConfig(tile_m=128, window_k=256, edge_chunk=256, precise=precise)
    rng = np.random.default_rng(n)
    b = rng.standard_normal((coo.shape[1], n)).astype(np.float32)
    c = rng.standard_normal((coo.shape[0], n)).astype(np.float32)
    pl = tx.plan(tx.pack_edge(coo, cfg), n, "edge", device=cuda)
    before = counters()
    outs = [pl(b, ALPHA, BETA, c), pl(b, ALPHA)]
    torch.cuda.synchronize()
    after = counters()
    grew = lambda name: after.get(name, 0) - before.get(name, 0)  # noqa: E731
    assert grew("launch.spmm_edge_padded") == 2
    for level in (1, 2):
        assert grew(f"launch.spmm_edge_padded.precise{level}") == 2 * (level == precise)
    if precise != 2:
        return
    csr = tx.CSRMatrix.from_coo(coo)
    for got, exact in zip(outs, (tx.golden_spmm_exact(csr, b, ALPHA, BETA, c),
                                 tx.golden_spmm_exact(csr, b, ALPHA))):
        floor = np.abs(exact.astype(np.float32).astype(np.float64) - exact)
        err = np.abs(got.cpu().numpy().astype(np.float64) - exact)
        assert int((err > floor).sum()) == 0


@pytest.mark.parametrize("precise", [0, 2])
@pytest.mark.parametrize("n", [16, 96])
@pytest.mark.parametrize("with_c", [True, False])
def test_edge_plan_in_place_equals_the_padded_kernel(cuda, with_c, n, precise):
    """The plan's edge route hands K4 B at its K rows and C and the output
    at M rows (the last K-window and M-tile ragged): the padded launch's
    rows, to the bit, and ``plan.in_place`` counted."""
    coo = tx.COOMatrix.random(1000, 1100, 9000, seed=8, banded=True, bandwidth=300)
    cfg = tx.SpmmConfig(tile_m=256, window_k=256, edge_chunk=136, edge_lanes=4,
                        precise=precise)
    packed = tx.pack_edge(coo, cfg)
    assert packed.k_padded > coo.shape[1] and packed.m_padded > coo.shape[0]
    pl = tx.plan(packed, n, "edge", device=cuda)
    rng = np.random.default_rng(n)
    b = rng.standard_normal((coo.shape[1], n)).astype(np.float32)
    c = rng.standard_normal((coo.shape[0], n)).astype(np.float32)
    before = counters().get("plan.in_place", 0)
    got = pl(b, ALPHA, BETA, c) if with_c else pl(b, ALPHA)
    c_p = pl.pad_c(c) if with_c else pl.no_c()
    want = spmm_edge_padded(*pl.arrays, pl.pad_b(b), c_p, ALPHA, BETA if with_c else 0.0,
                            tile_m=cfg.tile_m, window_k=cfg.window_k, edge_chunk=cfg.edge_chunk,
                            ranges=pl.ranges, with_c=with_c, precise=precise)
    torch.cuda.synchronize()
    assert counters().get("plan.in_place", 0) == before + 1
    assert got.shape == (coo.shape[0], n) and torch.equal(got, want[: coo.shape[0]])


@pytest.mark.parametrize("lanes", [1, 4])
@pytest.mark.parametrize("n", [8, 40])
@pytest.mark.parametrize("with_c", [True, False])
def test_edge_kernel_level_2_where_its_sums_cancel(cuda, with_c, n, lanes):
    """K4 at level 2 on rows whose sums cancel by about 2**24, where the
    check sends most elements back to be summed again from f64: the plain
    version's bits (which ``test_torch_edge_config.py`` holds to exact
    rationals), through the plan on the card."""
    from test_torch_edge_config import cancelling_plan

    plan, coo, b, c = cancelling_plan(lanes, n, device=cuda)
    cpu = cancelling_plan(lanes, n)[0]
    args = (b, ALPHA, BETA, c) if with_c else (b, ALPHA)
    got = plan(*args)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), cpu(*args))


def test_eft_probe_twin_on_card(cuda):
    a, b, v, bb = df32.probe_inputs(0)
    pairs_before, chain_before = launches(df32.eft_probe_pairs), launches(df32.eft_probe_chain)
    ta, tb = torch.as_tensor(a, device=cuda), torch.as_tensor(b, device=cuda)
    tv, tbb = torch.as_tensor(v, device=cuda), torch.as_tensor(bb, device=cuda)
    pairs = df32.eft_probe_pairs(ta, tb)
    chain = df32.eft_probe_chain(tv, tbb)
    torch.cuda.synchronize()
    assert launches(df32.eft_probe_pairs) == pairs_before + 1
    assert launches(df32.eft_probe_chain) == chain_before + 1
    for got, want in zip(pairs + (chain,),
                         df32.eft_probe_pairs_ref(ta, tb) + (df32.eft_probe_chain_ref(tv, tbb),)):
        assert torch.equal(got, want)
    report = df32.probe_report(a, b, v, bb, [t.cpu().numpy() for t in pairs], chain.cpu().numpy())
    assert report["two_sum_violations"] == report["two_prod_violations"] == 0
    assert report["add_mismatches"] == report["mul_mismatches"] == 0
    assert report["chain_above_floor"] == 0 and report["chain_excess"] <= 0.0


@pytest.mark.parametrize("precise", [1, 2])
@pytest.mark.parametrize("backend,n", [("pallas", 16), ("mxu", 16), ("mxu", 96), ("edge", 96)])
def test_precise_plan_on_card_launches_its_kernel(cuda, backend, n, precise):
    coo = _matrix("banded")
    cfg = tx.SpmmConfig(tile_m=256, window_k=256, block_k=8, group_blocks=16,
                        precise=precise)
    packer = {"pallas": tx.pack, "mxu": tx.pack_mxu, "edge": tx.pack_edge}[backend]
    kernel = {"pallas": spmm_block_padded, "edge": spmm_edge_padded,
              "mxu": spmm_slab_skinny_padded if n <= 32 else spmm_slab_padded}[backend]
    packed = packer(coo, cfg)
    rng = np.random.default_rng(1)
    b = rng.standard_normal((coo.shape[1], n)).astype(np.float32)
    c = rng.standard_normal((coo.shape[0], n)).astype(np.float32)
    before = launches(kernel)
    got = tx.plan(packed, n, backend, device=cuda)(b, ALPHA, BETA, c)
    torch.cuda.synchronize()
    assert launches(kernel) == before + 1 and got.device == cuda
    got = got.cpu()
    on_cpu = tx.plan(packed, n, backend, device="cpu")(b, ALPHA, BETA, c)
    exact = tx.golden_spmm_exact(tx.CSRMatrix.from_coo(coo), b, ALPHA, BETA, c)
    ulp = np.spacing(np.float32(np.abs(exact).max()))
    err = np.abs(got.numpy().astype(np.float64) - exact).max() / ulp
    if backend == "mxu":
        assert err <= 1.5
        assert (got - on_cpu).abs().max().item() <= 4 * ulp
    else:
        assert err <= (1.0 if precise == 1 else 0.5001)
        assert torch.equal(got, on_cpu)


# ---- precise ELL, DIA and hybrid ----

@pytest.mark.parametrize("precise", [1, 2])
@pytest.mark.parametrize("kind", ["banded", "hub_rows"])
@pytest.mark.parametrize("n", [1, 13, 64, 200])
def test_ell_kernel_precise_equals_plain(cuda, kind, n, precise):
    coo = _hub_matrix() if kind == "hub_rows" else _matrix(kind)
    packed = tx.pack_ell(coo, tx.SpmmConfig(tile_m=64, precise=precise), slots_per_row=8)
    _check_new(spmm_ell_gather_padded, spmm_ell_gather_padded_ref, cuda, packed,
               "ell_pallas", n, with_c=n != 13, precise=precise)


@pytest.mark.parametrize("n", [13, 64])
def test_ell_kernel_precise_selects_out_pads_with_nonfinite_b(cuda, n):
    coo = _matrix("banded")
    keep = coo.cols != 0
    coo = tx.COOMatrix(coo.shape, coo.rows[keep], coo.cols[keep], coo.vals[keep])
    _check_new(spmm_ell_gather_padded, spmm_ell_gather_padded_ref, cuda,
               tx.pack_ell(coo, tx.SpmmConfig(tile_m=64, precise=1), slots_per_row=32),
               "ell_pallas", n, with_c=True, nonfinite_b=True, precise=1)


@pytest.mark.parametrize("kind", ["stencil", "band", "rect"])
@pytest.mark.parametrize("n", [33, 64, 130, 512])
def test_dia_kernel_precise_equals_plain(cuda, kind, n):
    _check_dia(spmm_dia, cuda, _dia_split(kind), n, with_c=n != 64, precise=1)


@pytest.mark.parametrize("kind", ["stencil", "band", "rect"])
@pytest.mark.parametrize("n", [1, 13, 16, 32])
def test_dia_skinny_kernel_precise_equals_plain(cuda, kind, n):
    _check_dia(spmm_dia_skinny, cuda, _dia_split(kind), n, with_c=n != 13, precise=1)


@pytest.mark.parametrize("kernel,n", [(spmm_dia, 64), (spmm_dia_skinny, 16)])
def test_dia_kernels_precise_take_misaligned_b(cuda, kernel, n):
    _check_dia(kernel, cuda, _dia_split("band"), n, with_c=True, misaligned=True, precise=1)


@pytest.mark.parametrize("precise", [1, 2])
@pytest.mark.parametrize("backend,n", [("ell_pallas", 16), ("ell_pallas", 96), ("ell", 96)])
def test_precise_ell_plan_on_card_launches_its_kernel(cuda, backend, n, precise):
    coo = _hub_matrix()
    packed = tx.pack_ell(coo, tx.SpmmConfig(tile_m=64, precise=precise), slots_per_row=8)
    rng = np.random.default_rng(1)
    b = rng.standard_normal((coo.shape[1], n)).astype(np.float32)
    c = rng.standard_normal((coo.shape[0], n)).astype(np.float32)
    before = launches(spmm_ell_gather_padded)
    got = tx.plan(packed, n, backend, device=cuda)(b, ALPHA, BETA, c)
    torch.cuda.synchronize()
    assert launches(spmm_ell_gather_padded) == before + (backend == "ell_pallas")
    assert got.device == cuda
    got = got.cpu()
    exact = tx.golden_spmm_exact(tx.CSRMatrix.from_coo(coo), b, ALPHA, BETA, c)
    ulp = np.spacing(np.float32(np.abs(exact).max()))
    bar = 1.0 if backend == "ell_pallas" else 0.5001
    assert np.abs(got.numpy().astype(np.float64) - exact).max() <= bar * ulp
    if backend == "ell_pallas":
        on_cpu = tx.plan(packed, n, backend, device="cpu")(b, ALPHA, BETA, c)
        assert torch.equal(got, on_cpu)


@pytest.mark.parametrize("precise", [1, 2])
@pytest.mark.parametrize("n,backend", [(16, "pallas"), (64, "pallas"), (64, "ell_pallas")])
def test_precise_hybrid_plan_on_card_launches_its_kernels(cuda, n, backend, precise):
    # a circuit band with 3,000 scattered nonzeros: every part of the split
    base = circuit_like(3000, seed=2)
    rng = np.random.default_rng(4)
    lin, keep = np.unique(np.concatenate([base.rows, rng.integers(0, 3000, 3000)]) * 3000
                          + np.concatenate([base.cols, rng.integers(0, 3000, 3000)]),
                          return_index=True)
    vals = np.concatenate([base.vals, rng.standard_normal(3000).astype(np.float32)])[keep]
    coo = tx.COOMatrix((3000, 3000), (lin // 3000).astype(np.int32),
                       (lin % 3000).astype(np.int32), vals)
    split = tx.split_structure(coo, n=n, min_head_cols=1, min_head_rows=1)
    assert split.diag_offsets.size and split.head_rows.size and split.residue.nnz
    cfg = tx.SpmmConfig(tile_m=256, window_k=256, block_k=8, group_blocks=16)
    rng = np.random.default_rng(1)
    b = rng.standard_normal((3000, n)).astype(np.float32)
    c = rng.standard_normal((3000, n)).astype(np.float32)
    on_card = tx.HybridSpmmPlan(split, n, residue_config=cfg, backend=backend,
                                precise=precise, device=cuda)
    on_cpu = tx.HybridSpmmPlan(split, n, residue_config=cfg, backend=backend,
                               precise=precise, device="cpu")
    dia = spmm_dia_skinny if n <= 32 else spmm_dia
    residue = spmm_block_padded if backend == "pallas" else spmm_ell_gather_padded
    before = (launches(dia), launches(residue))
    got = on_card(b, ALPHA, BETA, c)
    torch.cuda.synchronize()
    assert (launches(dia), launches(residue)) == (before[0] + 1, before[1] + 1)
    assert got.device == cuda
    got = got.cpu().numpy()
    exact = tx.golden_spmm_exact(tx.CSRMatrix.from_coo(coo), b, ALPHA, BETA, c)
    # the head and hub-row matmuls (cuBLAS here, MKL on the CPU) sum in
    # another order: 4 ulp of max|C|, the plain hybrid's bar
    tol = 4 * np.spacing(np.float32(np.abs(exact).max()))
    assert tx.verify(exact, got).passed
    assert np.abs(got.astype(np.float64) - exact).max() <= tol
    assert np.abs(got - on_cpu(b, ALPHA, BETA, c).numpy()).max() <= tol
    chained = on_card.repeat(b, ALPHA, BETA, c, times=2)
    assert torch.equal(chained, on_card(b, ALPHA, BETA, on_card(b, ALPHA, BETA, c)))


# ---- the gather probes, P1's and P2's twins ----

# (k, m, r, n): chip_smoke.py's P1 and P2 shapes, a ragged N on 16-byte loads
# (100: 25 float4 over 32 lanes), a skinny N (16: 4 lanes a row) and the
# scalar path (99)
GATHER_SHAPES = [(4096, 512, 4, 256), (4096, 2048, 4, 512), (1000, 777, 3, 100),
                 (1000, 300, 5, 16), (1000, 301, 2, 99)]


def _gather_operands(cuda, k, m, r, n, zero_share=0.0):
    b, cols, vals = ell_issue.probe_inputs(0, k=k, n=n, r=r, m=m, zero_share=zero_share)
    return [torch.as_tensor(x, device=cuda) for x in (cols, vals, b)]


@pytest.mark.parametrize("k,m,r,n,staging,block", [
    (*shape, "direct", 256) for shape in GATHER_SHAPES] + [
    (*shape, "async", block) for shape in GATHER_SHAPES if shape[3] % 4 == 0
    for block in (256, 1024)])
def test_dma_gather_kernel_equals_plain(cuda, k, m, r, n, staging, block):
    cols, vals, b = _gather_operands(cuda, k, m, r, n)
    before = launches(dma_gather.gather_spmm)
    got = dma_gather.gather_spmm(cols, vals, b, staging=staging, block=block)
    torch.cuda.synchronize()
    assert launches(dma_gather.gather_spmm) == before + 1
    assert torch.equal(got, dma_gather.gather_spmm_ref(cols, vals, b))


@pytest.mark.parametrize("variant", ell_issue.VARIANTS)
@pytest.mark.parametrize("k,m,r,n", GATHER_SHAPES)
def test_ell_issue_kernel_equals_plain_and_keeps_pads_out(cuda, k, m, r, n, variant):
    cols, vals, b = _gather_operands(cuda, k, m, r, n, zero_share=0.3)
    cols[(vals == 0) & (torch.arange(m, device=cuda)[:, None] % 2 == 0)] = 0
    vals[3, 0], cols[3, 0] = 0.5, 0  # a nonzero slot on row 0
    want = ell_issue.ell_issue_ref(vals, cols, b)
    before = launches(ell_issue.ell_issue)
    assert torch.equal(ell_issue.ell_issue(vals, cols, b, variant=variant), want)
    b[0] = float("nan")
    got = ell_issue.ell_issue(vals, cols, b, variant=variant)
    torch.cuda.synchronize()
    assert launches(ell_issue.ell_issue) == before + 2
    hit = ((cols == 0) & (vals != 0)).any(dim=1)
    assert bool(hit[3]) and bool(((cols == 0) & (vals == 0)).any())
    assert torch.equal(~torch.isfinite(got).all(dim=1), hit)
    assert torch.equal(got[~hit], want[~hit])  # unchanged where B[0] is not met


def test_dma_gather_async_refuses_what_it_cannot_copy(cuda):
    cols, vals, b = _gather_operands(cuda, 1000, 64, 3, 99)
    with pytest.raises(ValueError, match="multiple of 4"):
        dma_gather.gather_spmm(cols, vals, b, staging="async")
    # a B 4 bytes off 16-byte alignment: async refuses, direct takes 4-byte loads
    cols, vals, b = _gather_operands(cuda, 1000, 64, 3, 100)
    shifted = torch.empty(b.numel() + 1, device=cuda)[1:].view(b.shape)
    shifted.copy_(b)
    assert shifted.data_ptr() % 16
    before = launches(dma_gather.gather_spmm)
    with pytest.raises(ValueError, match="16-byte aligned"):
        dma_gather.gather_spmm(cols, vals, shifted, staging="async")
    got = dma_gather.gather_spmm(cols, vals, shifted)
    torch.cuda.synchronize()
    assert launches(dma_gather.gather_spmm) == before + 1
    assert torch.equal(got, dma_gather.gather_spmm_ref(cols, vals, b))
    with pytest.raises(SharedMemoryError):
        dma_gather.gather_spmm(*_gather_operands(cuda, 16, 4, 8, 4096), staging="async")


def test_gather_probes_check_columns_on_the_card(cuda):
    cols, vals, b = _gather_operands(cuda, 1000, 64, 3, 16)
    cols[7, 1] = 1000
    vals[7, 1] = 1.0
    with pytest.raises(ValueError, match="outside"):
        dma_gather.gather_spmm(cols, vals, b)
    with pytest.raises(ValueError, match="outside"):
        ell_issue.ell_issue(vals, cols, b)
    vals[7, 1] = 0.0  # a pad's column may be anything
    assert torch.isfinite(ell_issue.ell_issue(vals, cols, b, variant="select")).all()


# ---- K2 streams its slab's blocks through shared memory; K6 stages a
# window of B per row tile and run of diagonals ----

@pytest.mark.parametrize("precise", [0, 1])
@pytest.mark.parametrize("bk", [32, 128])
@pytest.mark.parametrize("kind", ["long_stripe", "empty_mtiles"])
@pytest.mark.parametrize("n", [1, 7, 9, 32])
def test_slab_skinny_kernel_streams_long_slabs(cuda, kind, n, bk, precise):
    cfg = tx.SpmmConfig(tile_m=256, window_k=512, block_k=bk, group_blocks=4,
                        precise=precise)
    packed = tx.pack_mxu(_matrix(kind), cfg)
    # some slab holds more blocks than the ring has stages
    assert np.diff(slab_visits(packed)[0]).max() > SKINNY_STAGES
    _check(spmm_slab_skinny_padded, spmm_slab_padded_ref, cuda, packed, n,
           with_c=n != 7, precise=precise)


@pytest.mark.parametrize("precise", [0, 1])
@pytest.mark.parametrize("n", [9, 16])
def test_slab_skinny_kernel_pads_meet_nonfinite_b(cuda, n, precise):
    cfg = tx.SpmmConfig(tile_m=256, window_k=256, block_k=16, group_blocks=8,
                        precise=precise)
    packed = tx.pack_mxu(_matrix("empty_mtiles"), cfg)
    blocks = packed.vals.reshape(packed.n_groups * cfg.group_blocks, -1)
    assert (np.abs(blocks).max(axis=1) == 0).any()  # pad blocks, read B[window start]
    _check(spmm_slab_skinny_padded, spmm_slab_padded_ref, cuda, packed, n, with_c=True,
           precise=precise, poison=float("nan"))


@pytest.mark.parametrize("n", [4, 16])
def test_slab_skinny_kernel_takes_misaligned_b(cuda, n):
    cfg = tx.SpmmConfig(tile_m=256, window_k=512, block_k=32, group_blocks=4)
    packed = tx.pack_mxu(_matrix("banded"), cfg)
    pl = tx.plan(packed, n, "mxu", device=cuda)
    rng = np.random.default_rng(n)
    b = pl.pad_b(rng.standard_normal((packed.k, n)).astype(np.float32))
    c = pl.pad_c(rng.standard_normal((packed.m, n)).astype(np.float32))
    shifted = torch.empty(b.numel() + 1, device=cuda)[1:].view(b.shape)
    shifted.copy_(b)
    assert shifted.data_ptr() % 16  # 4-byte copies of B instead of one bulk copy
    kw = dict(tile_m=256, window_k=512, block_k=32, group_blocks=4, ranges=pl.ranges,
              m=packed.m, k=packed.k)
    got = spmm_slab_skinny_padded(*pl.arrays, shifted, c, ALPHA, BETA, **kw)
    want = spmm_slab_skinny_padded(*pl.arrays, b, c, ALPHA, BETA, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_slab_skinny_refuses_a_ring_that_does_not_fit(cuda):
    bk = 512  # beyond a config's block_k <= 128: two stages need 393 KB at N = 32
    i32 = dict(dtype=torch.int32, device=cuda)
    vals = torch.zeros((1, bk, 128), device=cuda)
    idx = torch.zeros((1, 1), **i32)
    ranges = (torch.tensor([0, 1], **i32), torch.zeros(1, **i32))
    b, c = torch.ones((bk, 32), device=cuda), torch.ones((128, 32), device=cuda)
    before = launches(spmm_slab_skinny_padded)
    with pytest.raises(SharedMemoryError, match="shared memory"):
        spmm_slab_skinny_padded(vals, idx, idx, torch.tensor([0, -1], **i32),
                                torch.zeros(1, **i32), b, c, 1.0, 0.0, tile_m=128,
                                window_k=bk, block_k=bk, group_blocks=1, ranges=ranges,
                                m=128, k=bk)
    assert launches(spmm_slab_skinny_padded) == before


@pytest.mark.parametrize("precise", [0, 1])
@pytest.mark.parametrize("cut", [0, 3, None])
@pytest.mark.parametrize("kind", ["band", "rect"])
@pytest.mark.parametrize("n", [37, 64])
def test_dia_kernel_runs_and_ragged_tiles_to_the_bit(cuda, kind, n, cut, precise):
    split = _dia_split(kind)
    assert split.m % 64  # the last row tile is ragged
    # band: offsets -60..60 run off both ends of B, two runs under dia_plan;
    # rect: 256 offsets in -438..758, many. A plan cut finer by hand (runs
    # of span 0 or 3) gives the same bits.
    if cut is None:
        assert dia_plan(split.diag_offsets, cuda).ptr.numel() - 1 >= 2
    _check_dia(spmm_dia, cuda, split, n, with_c=n == 37, precise=precise, cut=cut)


@pytest.mark.parametrize("precise", [0, 1])
@pytest.mark.parametrize("n", [37, 64])
def test_dia_kernel_multiplies_stored_zeros_with_nonfinite_b(cuda, n, precise):
    split = _dia_split("band")
    row = split.k // 2
    rows = row - split.diag_offsets
    inside = (rows >= 0) & (rows < split.m)
    # a stored zero of some diagonal reads B[row]: 0 * NaN gives NaN there
    assert (split.diag_vals[np.flatnonzero(inside), rows[inside]] == 0).any()
    _check_dia(spmm_dia, cuda, split, n, with_c=True, precise=precise, poison=row)


def test_dia_kernel_refuses_a_window_that_does_not_fit(cuda):
    m = k = 3000
    rng = np.random.default_rng(0)
    offsets = np.array([-1200, 1200])
    dv = torch.as_tensor(rng.standard_normal((2, m)).astype(np.float32), device=cuda)
    offs = torch.as_tensor(offsets.astype(np.int32), device=cuda)
    b = torch.ones((k, 64), device=cuda)
    c = torch.ones((m, 64), device=cuda)
    before = launches(spmm_dia)
    by_hand = DiaRuns(offs, torch.tensor([0, 2], dtype=torch.int32, device=cuda), 2400, 2)
    with pytest.raises(SharedMemoryError, match="shared memory"):
        spmm_dia(dv, offs, b, c, 1.0, 0.0, runs=by_hand)
    assert launches(spmm_dia) == before
    runs = dia_plan(offsets, cuda)  # two runs of one diagonal each
    assert runs.ptr.tolist() == [0, 1, 2] and (runs.span, runs.length) == (0, 1)
    got = spmm_dia(dv, runs.offsets, b, c, ALPHA, BETA, runs=runs)
    assert torch.equal(got, spmm_dia_ref(dv, offs, b, c, ALPHA, BETA))
    with pytest.raises(ValueError, match="runs"):
        spmm_dia(dv, offs, b, c, 1.0, 0.0)


@pytest.mark.parametrize("kernel,n", [(spmm_dia, 64), (spmm_dia_skinny, 16)])
@pytest.mark.parametrize("other", ["plan", "tensor"])
def test_dia_kernel_takes_only_the_offsets_its_plan_holds(cuda, other, kernel, n):
    m = k = 3000
    rng = np.random.default_rng(1)
    dv = torch.as_tensor(rng.standard_normal((2, m)).astype(np.float32), device=cuda)
    b = torch.ones((k, n), device=cuda)
    c = torch.ones((m, n), device=cuda)
    runs = dia_plan(np.array([-1200, 1200]), cuda)
    if other == "plan":  # a plan of other offsets, whose window is far narrower
        runs = dia_plan(np.array([0, 1]), cuda)
        offs = torch.tensor([-1200, 1200], dtype=torch.int32, device=cuda)
    else:  # the same values in another tensor
        offs = runs.offsets.clone()
    before = launches(kernel)
    with pytest.raises(ValueError, match="runs.offsets"):
        kernel(dv, offs, b, c, 1.0, 0.0, runs=runs)
    assert launches(kernel) == before


# ---- K1 streams its slab's blocks through shared memory and contracts
# them on the tensor cores in 3xTF32; K7 stages a window of B per 16-row
# tile and run of diagonals ----

def _check_slab_f64(cuda, coo, packed, n, with_c):
    """K1 in plain mode (3xTF32 on the tensor cores) against the f64 oracle
    and its plain version (FFMA order): rows of 2,600 terms take both f32
    sums past the 4-ulp bar of f64 and apart from each other (the plain
    version itself reads 4.7 ulp there on an H100), so the kernel is held
    to be no more than 1 ulp of max|C| further from f64 than the plain
    version is, and within 4 ulp of f64 where the plain version is."""
    pl = tx.plan(packed, n, "mxu", device=cuda)
    rng = np.random.default_rng(n)
    b = rng.standard_normal((packed.k, n)).astype(np.float32)
    c = rng.standard_normal((packed.m, n)).astype(np.float32)
    before = launches(spmm_slab_padded)
    beta, c_in = (BETA, c) if with_c else (0.0, None)
    got = pl(b, ALPHA, beta, c_in).cpu().numpy()
    assert launches(spmm_slab_padded) == before + 1
    plain = tx.plan(packed, n, "mxu", device="cpu")(b, ALPHA, beta, c_in).numpy()
    exact = tx.golden_spmm_exact(tx.CSRMatrix.from_coo(coo), b, ALPHA, beta, c_in)
    unit = np.spacing(np.float32(np.abs(exact).max()))
    err, plain_err = np.abs(got - exact).max() / unit, np.abs(plain - exact).max() / unit
    assert err <= max(4.0, plain_err + 1.0)


@pytest.mark.parametrize("precise", [0, 1, 2])
@pytest.mark.parametrize("with_c", [True, False])
@pytest.mark.parametrize("kind,bk", [("long_stripe", 32), ("long_stripe", 128),
                                     ("empty_mtiles", 128)])
@pytest.mark.parametrize("n", [37, 100])
def test_slab_kernel_streams_long_slabs(cuda, kind, bk, n, with_c, precise):
    cfg = tx.SpmmConfig(tile_m=256, window_k=512, block_k=bk, group_blocks=4,
                        precise=precise)
    coo = _matrix(kind)
    packed = tx.pack_mxu(coo, cfg)
    if kind == "long_stripe":  # some slab holds more blocks than the ring has stages
        assert np.diff(slab_visits(packed)[0]).max() > SKINNY_STAGES
    if precise:  # FFMA, as the plain version
        _check(spmm_slab_padded, spmm_slab_padded_ref, cuda, packed, n, with_c=with_c,
               precise=precise)
    else:
        _check_slab_f64(cuda, coo, packed, n, with_c)


@functools.lru_cache(maxsize=None)
def _whole_slab_pack(bk):
    """A pack whose 529 slabs give the whole-slab tiles even at N <= 128
    (``slab_launch``): a band 90 columns wide, six entries a row, and slabs
    8-15 without a block."""
    m, k = 529 * 128, 3000
    base = tx.COOMatrix.random(m, k, 6 * m, seed=5, banded=True, bandwidth=90)
    keep = (base.rows < 1024) | (base.rows >= 2048)
    coo = tx.COOMatrix((m, k), base.rows[keep], base.cols[keep], base.vals[keep])
    cfg = tx.SpmmConfig(tile_m=1024, window_k=1024, block_k=bk, group_blocks=max(1, 128 // bk))
    return tx.pack_mxu(coo, cfg)


@pytest.mark.parametrize("with_c", [True, False])
@pytest.mark.parametrize("variant,bk,n", [
    ("half", 8, 37), ("half", 16, 100), ("half", 32, 64), ("half", 64, 100),
    ("whole", 8, 100), ("whole", 16, 512), ("whole", 32, 100), ("whole", 64, 200),
    ("whole", 128, 100)])
def test_slab_kernel_overlap_ragged_edges(cuda, variant, bk, n, with_c):
    """K1's overlapped mainloop at its edges, against its plain version:
    chunks of one, two and four 8-term steps (block_k 8, 16, and 32 or
    more), slabs without a block (beta * C) and slabs of more chunks than
    the ring has stages, N whose last column tile is partly outside, with
    and without C, in both tile shapes."""
    if variant == "half":
        cfg = tx.SpmmConfig(tile_m=256, window_k=512, block_k=bk, group_blocks=4)
        packed = tx.pack_mxu(_matrix("empty_mtiles"), cfg)
    else:
        packed = _whole_slab_pack(bk)
    blocks = np.diff(slab_visits(packed)[0])
    assert (blocks == 0).any() and blocks.max() * max(1, bk // 32) > 4
    go = slab_launch(n, packed.m_padded // 128, bk)
    assert go.threads == {"half": 128, "whole": 256}[variant]
    _check(spmm_slab_padded, spmm_slab_padded_ref, cuda, packed, n, with_c=with_c)


def test_k1_wgmmas_are_not_serialised(record_property, tmp_path):
    """ptxas keeps K1's wgmmas in flight: ``csrc/spmm_slab.cu`` compiled as
    ``runtime/build.py`` compiles it, with ``-Xptxas -v``, draws no note
    that it serialises the wgmmas (C7514, C7515: another instruction may
    read or write a running wgmma's registers) for any
    ``spmm_slab_tc_kernel`` instantiation; each instantiation's registers
    and spills are recorded."""
    from sextans_tpu_torch.runtime import build

    try:
        nvcc = build.find_nvcc()
    except RuntimeError as err:
        pytest.skip(str(err))
    src = build.CSRC_DIR / "spmm_slab.cu"
    proc = subprocess.run(
        [nvcc, *build.NVCC_FLAGS, "-I", str(build.CSRC_DIR), "-Xptxas", "-v", "-c",
         "-o", str(tmp_path / "spmm_slab.o"), str(src)], capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    assert proc.returncode == 0, log
    serialised = [line for line in log.splitlines()
                  if "serialized" in line and "spmm_slab_tc_kernel" in line]
    assert not serialised, "\n".join(serialised)
    # ptxas names a kernel, then gives its spills and registers
    seen, name = {}, None
    for line in log.splitlines():
        named = re.search(r"(?:Compiling entry function '|Function properties for )([^' ]+)",
                          line)
        if named:
            name = named.group(1)
        elif name and "spmm_slab_tc_kernel" in name:
            if "spill stores" in line:
                seen.setdefault(name, {})["spills"] = line.strip()
            elif "Used" in line and "registers" in line:
                seen.setdefault(name, {})["registers"] = int(
                    line.split("Used", 1)[1].split("registers")[0])
    # two tile shapes by chunks of one, two and four steps, each a kernel for
    # the edge slabs and one for the other slabs
    assert len(seen) == 12 and all("registers" in v for v in seen.values()), log
    assert sum("spmm_slab_tc_kernel_edge" in name for name in seen) == 6, log
    for kernel, info in seen.items():
        record_property(kernel, str(info))
        print(f"{kernel}: {info}")


@pytest.mark.parametrize("precise", [0, 1])
@pytest.mark.parametrize("poison", [float("nan"), float("inf")])
@pytest.mark.parametrize("n", [37, 100])
def test_slab_kernel_pads_meet_nonfinite_b(cuda, n, poison, precise):
    cfg = tx.SpmmConfig(tile_m=256, window_k=256, block_k=16, group_blocks=8,
                        precise=precise)
    packed = tx.pack_mxu(_matrix("empty_mtiles"), cfg)
    blocks = packed.vals.reshape(packed.n_groups * cfg.group_blocks, -1)
    assert (np.abs(blocks).max(axis=1) == 0).any()  # pad blocks, read B[window start]
    _check(spmm_slab_padded, spmm_slab_padded_ref, cuda, packed, n, with_c=True,
           precise=precise, poison=poison)


@pytest.mark.parametrize("n", [64, 100])
def test_slab_kernel_takes_misaligned_b(cuda, n):
    cfg = tx.SpmmConfig(tile_m=256, window_k=512, block_k=32, group_blocks=4)
    packed = tx.pack_mxu(_matrix("banded"), cfg)
    pl = tx.plan(packed, n, "mxu", device=cuda)
    rng = np.random.default_rng(n)
    b = pl.pad_b(rng.standard_normal((packed.k, n)).astype(np.float32))
    c = pl.pad_c(rng.standard_normal((packed.m, n)).astype(np.float32))
    shifted = torch.empty(b.numel() + 1, device=cuda)[1:].view(b.shape)
    shifted.copy_(b)
    assert shifted.data_ptr() % 16  # 4-byte copies of B's rows instead of 16-byte ones
    kw = dict(tile_m=256, window_k=512, block_k=32, group_blocks=4, ranges=pl.ranges,
              image=pl.image, m=packed.m, k=packed.k)
    got = spmm_slab_padded(*pl.arrays, shifted, c, ALPHA, BETA, **kw)
    want = spmm_slab_padded(*pl.arrays, b, c, ALPHA, BETA, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_slab_kernel_needs_its_image_and_slab_lists(cuda):
    cfg = tx.SpmmConfig(tile_m=256, window_k=256, block_k=16, group_blocks=8)
    packed = tx.pack_mxu(_matrix("banded"), cfg)
    pl = tx.plan(packed, 40, "mxu", device=cuda)
    assert pl.image is not None and tx.plan(packed, 16, "mxu", device=cuda).image is None
    b = pl.pad_b(np.ones((packed.k, 40), np.float32))
    c = pl.pad_c(np.ones((packed.m, 40), np.float32))
    kw = dict(tile_m=256, window_k=256, block_k=16, group_blocks=8, ranges=pl.ranges,
              m=packed.m, k=packed.k)
    before = launches(spmm_slab_padded)
    with pytest.raises(ValueError, match="image"):
        spmm_slab_padded(*pl.arrays, b, c, 1.0, 0.0, **kw)
    with pytest.raises(ValueError, match="image must have shape"):
        spmm_slab_padded(*pl.arrays, b, c, 1.0, 0.0, **kw, image=pl.image[1:])
    with pytest.raises(ValueError, match="slab_blocks"):
        spmm_slab_padded(*pl.arrays, b, c, 1.0, 0.0, **{**kw, "ranges": (
            pl.ranges[0], pl.ranges[1][1:], pl.ranges[2][1:])}, image=pl.image)
    assert launches(spmm_slab_padded) == before


# ---- K1 and K2 take B and C where they lie: B at K rows, C and the output
# at M rows ----

SENTINEL = 12345.0


@functools.lru_cache(maxsize=None)
def _ragged_slab_pack(variant, precise):
    """K a multiple of neither block_k nor window_k, M not a multiple of
    128. ``half``: 300 x 250, slab 3 wholly past M; ``whole``: 67,699 x
    3,000, whose 536 slabs give K1 the whole-slab tiles at N <= 128, the
    last seven wholly past M."""
    if variant == "half":
        coo = tx.COOMatrix.random(300, 250, 3000, seed=3, banded=True, bandwidth=60)
        cfg = tx.SpmmConfig(tile_m=256, window_k=128, block_k=32, group_blocks=4)
    else:
        m = 529 * 128 - 13
        coo = tx.COOMatrix.random(m, 3000, 6 * m, seed=5, banded=True, bandwidth=90)
        cfg = tx.SpmmConfig(tile_m=1024, window_k=1024, block_k=32, group_blocks=4)
    return coo, tx.pack_mxu(coo, cfg.with_(precise=precise))


def _padded_kernel_call(pl, b, c, with_c):
    """The plan's kernel on B and C padded to k_padded and m_padded, bound
    to those rows: no edge slab, so K1 on the tensor cores runs one grid."""
    kernel = pl._run.func
    kw = {**pl._run.keywords, "m": pl.packed.m_padded, "k": pl.k_padded}
    return kernel(*pl.arrays, pl.pad_b(b), pl.pad_c(c) if with_c else pl.no_c(), ALPHA,
                  BETA if with_c else 0.0, with_c=with_c, **kw)


@pytest.mark.parametrize("precise", [0, 1])
@pytest.mark.parametrize("with_c", [True, False])
@pytest.mark.parametrize("variant,n", [("half", 13), ("half", 16), ("half", 37), ("half", 100),
                                       ("whole", 100), ("whole", 512)])
def test_slab_plan_in_place_equals_the_padded_kernel(cuda, variant, n, with_c, precise,
                                                     monkeypatch):
    """SpmmPlan's call hands K1 (plain on the tensor cores, or precise on
    FFMA) and K2 (N <= 32) B as the first K rows of a tensor whose later
    rows are NaN and C as the first M rows of another, and takes back an
    output whose buffer holds a sentinel past row M: the output is finite,
    the padded call's rows to the bit, and no row past M is written; 16- and
    4-byte copies of B (N % 4), and ``plan.in_place`` counted."""
    coo, packed = _ragged_slab_pack(variant, precise)
    (m, k), kp, mp = coo.shape, packed.k_padded, packed.m_padded
    pl = tx.plan(packed, n, "mxu", device=cuda)
    kernel = spmm_slab_skinny_padded if n <= 32 else spmm_slab_padded
    assert pl._run.func is kernel and (pl._b_rows, pl._c_rows) == (k, m)
    rng = np.random.default_rng(n)
    b = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32)).to(cuda)
    c = torch.from_numpy(rng.standard_normal((m, n)).astype(np.float32)).to(cuda)
    b_big = torch.full((kp + 64, n), float("nan"), device=cuda)
    c_big = torch.full((mp + 64, n), float("nan"), device=cuda)
    b_big[:k], c_big[:m] = b, c
    out_buf = torch.full((mp, n), SENTINEL, device=cuda)
    real_empty = torch.empty

    def empty(*size, **kw):  # the wrapper's output: the first M rows of out_buf
        shape = tuple(size[0]) if len(size) == 1 and isinstance(size[0], (tuple, list)) else size
        return out_buf[:m] if shape == (m, n) else real_empty(*size, **kw)

    before, in_place = launches(kernel), counters().get("plan.in_place", 0)
    monkeypatch.setattr(torch, "empty", empty)
    got = pl(b_big[:k], ALPHA, BETA, c_big[:m]) if with_c else pl(b_big[:k], ALPHA)
    monkeypatch.undo()
    torch.cuda.synchronize()
    assert launches(kernel) == before + 1
    assert counters().get("plan.in_place", 0) == in_place + 1
    assert got.data_ptr() == out_buf.data_ptr() and got.shape == (m, n)
    assert bool((out_buf[m:] == SENTINEL).all())
    assert bool(torch.isfinite(got).all())
    want = _padded_kernel_call(pl, b, c, with_c)
    torch.cuda.synchronize()
    assert want.shape == (mp, n) and torch.equal(got, want[:m])
    if with_c:  # repeat carries the padded C; a C short of M rows is refused
        assert torch.equal(pl.repeat(b, ALPHA, BETA, c, times=2), pl(b, ALPHA, BETA, got))
        with pytest.raises(ValueError, match="rows"):
            pl._run(*pl.arrays, b, c[: m - 1], ALPHA, BETA)


@pytest.mark.parametrize("precise", [0, 1])
@pytest.mark.parametrize("cut", [1, 100])
@pytest.mark.parametrize("n", [13, 16, 37, 100])
def test_slab_kernels_read_past_bs_rows_as_zeros(cuda, n, cut, precise):
    """K1 and K2 handed B of K - ``cut`` rows: the rows past it read as
    zeros, so the output is the bits of the padded call with those rows
    zeroed, blocks that straddle B's end and blocks wholly past it (cut 100)
    alike."""
    coo, packed = _ragged_slab_pack("half", precise)
    (m, k), kp = coo.shape, packed.k_padded
    pl = tx.plan(packed, n, "mxu", device=cuda)
    rng = np.random.default_rng(cut)
    b = torch.from_numpy(rng.standard_normal((k - cut, n)).astype(np.float32)).to(cuda)
    c = torch.from_numpy(rng.standard_normal((m, n)).astype(np.float32)).to(cuda)
    rows = slab_visits(packed)[2]
    assert (rows + packed.config.block_k > k - cut).any()
    assert (rows >= k - cut).any() == (cut == 100)
    zeros = torch.zeros((kp, n), device=cuda)
    zeros[: k - cut] = b
    got = pl._run(*pl.arrays, b, c, ALPHA, BETA, k=k - cut)
    want = pl._run(*pl.arrays, zeros, pl.pad_c(c), ALPHA, BETA)[:m]
    torch.cuda.synchronize()
    assert got.shape == (m, n) and torch.equal(got, want)


@pytest.mark.parametrize("precise", [0, 1])
@pytest.mark.parametrize("n", [16, 100])
@pytest.mark.parametrize("shape", [(300, 0), (0, 200), (0, 0)])
def test_slab_plan_in_place_on_an_empty_matrix(cuda, shape, n, precise):
    """A matrix of no rows or no columns goes in place too: with no B rows
    every block's B reads as zeros, so the output is beta * C, the padded
    call's bits; with no rows every CTA returns and the output has none."""
    coo = tx.COOMatrix(shape, [], [], [])
    cfg = tx.SpmmConfig(tile_m=256, window_k=128, block_k=32, group_blocks=4,
                        precise=precise)
    pl = tx.plan(tx.pack_mxu(coo, cfg), n, "mxu", device=cuda)
    assert pl._in_place
    rng = np.random.default_rng(n)
    b = torch.from_numpy(rng.standard_normal((shape[1], n)).astype(np.float32)).to(cuda)
    c = torch.from_numpy(rng.standard_normal((shape[0], n)).astype(np.float32)).to(cuda)
    got = pl(b, ALPHA, BETA, c)
    want = _padded_kernel_call(pl, b, c, True)
    torch.cuda.synchronize()
    assert got.shape == (shape[0], n) and torch.equal(got, want[: shape[0]])


@pytest.mark.parametrize("precise", [0, 1])
@pytest.mark.parametrize("cut", [0, 3, None])
@pytest.mark.parametrize("kind", ["stencil", "band", "rect"])
@pytest.mark.parametrize("n", [9, 13, 16])
def test_dia_skinny_kernel_runs_and_ragged_tiles_to_the_bit(cuda, kind, n, cut, precise):
    split = _dia_split(kind)
    # K7 equals its plain version to the bit under any cut of the offsets
    # into runs; 16-row tiles, the last one ragged where M is not a multiple
    _check_dia(spmm_dia_skinny, cuda, split, n, with_c=n != 13, precise=precise, cut=cut)


@pytest.mark.parametrize("precise", [0, 1])
@pytest.mark.parametrize("n", [9, 16])
def test_dia_skinny_kernel_meets_nonfinite_b_and_rows_off_b(cuda, n, precise):
    split = _dia_split("band")  # offsets -60..60 run off both ends of B
    _check_dia(spmm_dia_skinny, cuda, split, n, with_c=True, precise=precise,
               poison=split.k // 2)


SERVE_GPU_CASES = [("vpu", "pallas", 16), ("vpu", "pallas", 96), ("vpu", "xla", 40),
                   ("mxu", "mxu", 16), ("mxu", "mxu", 96), ("edge", "edge", 16),
                   ("edge", "edge", 96), ("ell", "ell", 40)]


@pytest.mark.parametrize("precise", [0, 1])
@pytest.mark.parametrize("fmt,backend,n", SERVE_GPU_CASES)
def test_server_on_card_equals_the_unbucketed_plan(cuda, tmp_path, fmt, backend, n, precise):
    """Two matrices of one bucket served on the card through the pack
    cache: each product equal to SpmmPlan on the unbucketed pack (K1 in
    plain mode, on the tensor cores, within 4 ulp of max|C|), the second
    in a warm bucket, and no kernel build after the first plan."""
    from sextans_tpu_torch.ops.plan import FORMATS
    from sextans_tpu_torch.runtime.build import build_kernels

    cfg = tx.SpmmConfig(tile_m=256, window_k=256, block_k=8, group_blocks=16,
                        precise=precise)
    cache = tx.PackCache(root=tmp_path)
    server = tx.SpmmServer(n, config=cfg, fmt=fmt, backend=backend, pack_cache=cache,
                           device=cuda)
    mats = [tx.COOMatrix.random(1030, 777, 12000, seed=3, banded=True, bandwidth=90),
            tx.COOMatrix.random(1045, 790, 12100, seed=4, banded=True, bandwidth=90)]
    builds = None
    for i, coo in enumerate(mats):
        plan = server.plan(coo, f"m{i}")
        assert plan.bucket_new == (i == 0)
        if builds is None:
            plan(np.zeros((coo.shape[1], n), np.float32))  # the first launch builds
            builds = build_kernels.cache_info().misses  # the library builds on a miss
        rng = np.random.default_rng(i)
        b = rng.standard_normal((coo.shape[1], n)).astype(np.float32)
        c = rng.standard_normal((coo.shape[0], n)).astype(np.float32)
        got = plan(b, ALPHA, BETA, c)
        assert got.device == cuda and got.shape == (coo.shape[0], n)
        want = tx.SpmmPlan(FORMATS[fmt](coo, cfg), n, backend,
                           device=cuda)(b, ALPHA, BETA, c)
        if fmt == "mxu" and n > 32 and not precise:
            unit = np.spacing(np.float32(want.abs().max().item()))
            assert (got - want).abs().max().item() <= 4 * unit
        else:
            assert torch.equal(got, want)
        exact = tx.golden_spmm_exact(tx.CSRMatrix.from_coo(coo), b, ALPHA, BETA, c)
        assert tx.verify(exact, got.cpu().numpy()).passed
    assert build_kernels.cache_info().misses == builds


# ---- the differentiable SpMM (ops/autodiff.py) on the card ----

VALUE_GPU_CASES = [("vpu", 0, 64), ("vpu", 0, 16), ("vpu", 1, 64), ("mxu", 0, 64),
                   ("mxu", 0, 16), ("mxu", 1, 64), ("edge", 0, 64), ("ell", 0, 64),
                   ("ell", 1, 16)]


def _value_kernel(fmt, n):
    from sextans_tpu_torch.ops.spmm_slab import spmm_slab_skinny_padded

    return {"vpu": spmm_block_padded, "edge": spmm_edge_padded,
            "ell": spmm_ell_gather_padded,
            "mxu": spmm_slab_padded if n > 32 else spmm_slab_skinny_padded}[fmt]


@pytest.mark.parametrize("zero_blocks", [False, True])
@pytest.mark.parametrize("fmt,precise,n", VALUE_GPU_CASES)
def test_value_op_on_card_matches_its_plain_versions(cuda, fmt, precise, n, zero_blocks):
    """``spmm_value_op`` on the card against the same op on the CPU's plain
    versions: A(vals) @ B and A^T @ G within 4 ulp of max|.| (the kernels'
    bands against their plain versions), dvals (the SDDMM, summed in
    another order) within 4 ulp of max|dvals|, dC equal, dalpha and dbeta
    within 2^-20 of sum|G * AB| (sum|G * C|); the kernel launched forward
    and backward. With ``zero_blocks`` the op is built from values that are
    zero on rows 0-299 (whole blocks, slabs and stripes) and run with the
    nonzero ones: its scans walk the structure, so the card still agrees."""
    coo = tx.COOMatrix.random(1030, 777, 12000, seed=3, banded=True, bandwidth=90)
    built = coo
    if zero_blocks:
        built = tx.COOMatrix(coo.shape, coo.rows, coo.cols,
                             np.where(coo.rows < 300, 0.0, coo.vals).astype(np.float32))
    cfg = tx.SpmmConfig(tile_m=256, window_k=256, block_k=8, group_blocks=16,
                        precise=precise)
    rng = np.random.default_rng(n)
    b = rng.standard_normal((777, n)).astype(np.float32)
    c = rng.standard_normal((1030, n)).astype(np.float32)
    g = rng.standard_normal((1030, n)).astype(np.float32)
    results = {}
    kernel = _value_kernel(fmt, n)
    for key, dev in (("card", cuda), ("plain", torch.device("cpu"))):
        op = tx.spmm_value_op(built, n, config=cfg, fmt=fmt, device=dev)
        args = [torch.tensor(x, device=dev, requires_grad=True) for x in (coo.vals, b, c)]
        args += [torch.tensor(x, device=dev, requires_grad=True) for x in (ALPHA, BETA)]
        before = launches(kernel)
        out = op(*args)
        forward = launches(kernel) - before
        out.backward(torch.as_tensor(g, device=dev))
        backward = launches(kernel) - before - forward
        with torch.no_grad():
            parts = (op.ab(args[0], args[1]), op.atg(args[0], torch.as_tensor(g, device=dev)))
        results[key] = [x.detach().cpu() for x in (out, *parts)] + [
            a.grad.cpu() for a in args]
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert forward >= 1 and backward >= 1
    (out, ab, atg, dvals, db, dc, dalpha, dbeta) = results["card"]
    (out0, ab0, atg0, dvals0, db0, dc0, dalpha0, dbeta0) = results["plain"]
    for got, want in ((ab, ab0), (atg, atg0), (dvals, dvals0), (db, db0)):
        assert torch.isfinite(got).all()
        assert (got - want).abs().max().item() <= 4 * np.spacing(
            np.float32(want.abs().max().item()))
    assert torch.equal(dc, dc0)
    unit = np.spacing(np.float32(out0.abs().max().item()))
    assert (out - out0).abs().max().item() <= 5 * unit
    g64 = g.astype(np.float64)
    ab64 = ab0.double().numpy()
    assert abs(dalpha.item() - dalpha0.item()) <= 2.0**-20 * np.abs(g64 * ab64).sum()
    assert abs(dbeta.item() - dbeta0.item()) <= 2.0**-20 * np.abs(g64 * c).sum()


@pytest.mark.parametrize("fmt", ["vpu", "mxu", "edge", "ell"])
def test_value_scatter_on_card_reproduces_the_pack(cuda, fmt):
    """The value op's scatter on the card gives the pack's values to the
    bit, duplicates summed in COO entry order (``index_add_`` and
    ``index_put_(accumulate=True)`` would add them in atomic order)."""
    from sextans_tpu_torch.ops.autodiff import ValueScatter
    from sextans_tpu_torch.ops.plan import FORMATS

    rng = np.random.default_rng(8)
    rows = rng.integers(0, 40, 6000)  # ~4 entries a coordinate
    cols = rng.integers(0, 50, 6000)
    vals = (rng.standard_normal(6000) * 2.0 ** rng.integers(-20, 20, 6000)).astype(np.float32)
    coo = tx.COOMatrix((300, 260), rows, cols, vals)
    cfg = tx.SpmmConfig(tile_m=128, window_k=128, block_k=8, group_blocks=16, ell_r=4)
    packed = FORMATS[fmt](coo, cfg)
    scatter = ValueScatter(tx.slot_map(coo, cfg, fmt), packed.vals.shape, cuda)
    got = scatter(torch.as_tensor(vals, device=cuda)).cpu().numpy()
    assert got.tobytes() == np.ascontiguousarray(packed.vals).tobytes()


def test_train_sparse_example_on_card(cuda):
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "examples" / "train_sparse_torch.py"
    spec = importlib.util.spec_from_file_location("train_sparse_torch", path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    assert example.main(["--device", "cuda"]) < 1e-4


# ---- the SDDMM kernel (csrc/sddmm.cu) behind d/dvals ----

def _sddmm_matrix(order):
    """Duplicates (~2 entries a coordinate), empty rows (every fourth holds
    entries), a finite-element block of rows with equal columns and a row
    of 700 columns, past one tile; rows in CSR order or shuffled."""
    rng = np.random.default_rng(11)
    fem = fem_like(240, dofs=3, neighbors=9, seed=4)
    rows = np.concatenate([4 * rng.integers(0, 100, 5000), fem.rows + 400, np.full(700, 2)])
    cols = np.concatenate([rng.integers(0, 300, 5000), fem.cols, np.arange(700)])
    coo = tx.COOMatrix((640, 700), rows, cols, np.ones(rows.size, np.float32))
    if order == "sorted":
        return coo.sorted_by_row()
    p = rng.permutation(coo.nnz)
    return tx.COOMatrix(coo.shape, coo.rows[p], coo.cols[p], coo.vals[p])


@pytest.mark.parametrize("order", ["sorted", "shuffled"])
@pytest.mark.parametrize("n", [1, 16, 40, 512, 600])
def test_sddmm_kernel_matches_its_plain_version(cuda, n, order):
    """The kernel within 4 ulp of max|dvals| of the plain version (which
    sums in another order), and equal to the bit to the host walk of its own
    arithmetic over the plan (``sddmm_rows_walk``); one launch."""
    from sextans_tpu_torch.ops.sddmm import (sddmm_plan, sddmm_rows, sddmm_rows_ref,
                                             sddmm_rows_walk, sddmm_tiles)

    a = _sddmm_matrix(order)
    m, k = a.shape
    rng = np.random.default_rng(n)
    g = torch.tensor(rng.standard_normal((m, n)), dtype=torch.float32)
    b = torch.tensor(rng.standard_normal((k, n)), dtype=torch.float32)
    rows = torch.as_tensor(a.rows.astype(np.int64))
    cols = torch.as_tensor(a.cols.astype(np.int64))
    tiles = sddmm_plan(a.rows, a.cols, a.shape, cuda)
    assert (tiles.perm is None) == (order == "sorted")
    before = launches(sddmm_rows)
    got = sddmm_rows(g.to(cuda), b.to(cuda), rows.to(cuda), cols.to(cuda), tiles=tiles)
    torch.cuda.synchronize()
    assert launches(sddmm_rows) - before == 1
    got = got.cpu()
    want = sddmm_rows_ref(g, b, rows, cols)
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= 4 * np.spacing(
        np.float32(want.abs().max().item()))
    walk = sddmm_rows_walk(sddmm_tiles(a.rows, a.cols, a.shape), g, b, 4 if n % 4 == 0 else 1)
    assert torch.equal(got, walk)


def test_sddmm_kernel_with_no_entry_launches_nothing(cuda):
    from sextans_tpu_torch.ops.sddmm import sddmm_plan, sddmm_rows

    a = tx.COOMatrix((5, 4), [], [], [])
    tiles = sddmm_plan(a.rows, a.cols, a.shape, cuda)
    before = launches(sddmm_rows)
    idx = torch.zeros(0, dtype=torch.int64, device=cuda)
    out = sddmm_rows(torch.ones(5, 8, device=cuda), torch.ones(4, 8, device=cuda), idx, idx,
                     tiles=tiles)
    assert out.shape == (0,) and launches(sddmm_rows) == before


def test_sddmm_kernel_refuses_tiles_of_other_coordinates(cuda):
    """The kernel reads the coordinates from the tiles alone: a plan that
    holds another number of entries than ``rows`` is refused, unlaunched."""
    from sextans_tpu_torch.ops.sddmm import sddmm_plan, sddmm_rows

    a = tx.COOMatrix.random(50, 40, 300, seed=3)
    tiles = sddmm_plan(a.rows[:-1], a.cols[:-1], a.shape, cuda)
    rows = torch.as_tensor(a.rows.astype(np.int64), device=cuda)
    cols = torch.as_tensor(a.cols.astype(np.int64), device=cuda)
    before = launches(sddmm_rows)
    with pytest.raises(ValueError, match="entries"):
        sddmm_rows(torch.ones(50, 8, device=cuda), torch.ones(40, 8, device=cuda), rows, cols,
                   tiles=tiles)
    assert launches(sddmm_rows) == before


def test_sddmm_launches_once_a_backward_that_needs_dvals(cuda):
    """``launch.sddmm_rows`` grows by one per backward that needs dvals and
    stays still where ``vals`` needs no gradient (``spmm_op`` too)."""
    from sextans_tpu_torch.ops.sddmm import sddmm_rows

    coo = tx.COOMatrix.random(300, 260, 3000, seed=6)
    cfg = tx.SpmmConfig(tile_m=128, window_k=128, block_k=8, group_blocks=16)
    op = tx.spmm_value_op(coo, 32, config=cfg, fmt="mxu", device=cuda)
    vals = torch.tensor(coo.vals, device=cuda)
    b = torch.randn(260, 32, device=cuda, requires_grad=True)
    c = torch.randn(300, 32, device=cuda)
    for need_vals, grows in ((True, 1), (False, 0)):
        v = vals.clone().requires_grad_(need_vals)
        before = launches(sddmm_rows)
        for _ in range(3):
            op(v, b, c, ALPHA, BETA).square().sum().backward()
        assert launches(sddmm_rows) - before == 3 * grows
    f = tx.spmm_op(coo, 32, ALPHA, BETA, config=cfg, fmt="mxu", device=cuda)
    before = launches(sddmm_rows)
    f(b, c).sum().backward()
    assert launches(sddmm_rows) == before


@pytest.mark.parametrize("fmt", ["mxu", "ell"])
def test_value_op_gradients_on_cant_like(cuda, fmt):
    """The value op's five gradients on cant_like at N = 512, held as
    ``chip_smoke.py`` phase 12 holds them: dvals (the SDDMM kernel) and dB
    (K1 or K5 over A^T) within 4 ulp of max against f64, dC = beta * G to
    the bit, dalpha and dbeta within 2^-20 of sum|G * AB| (sum|G * C|)."""
    from sextans_tpu_torch.ops.sddmm import sddmm_rows
    from sextans_tpu_torch.utils.device_verify import device_full_check

    n = 512
    coo = fem_like(62451, dofs=3, neighbors=21, seed=2)
    cfg = (tx.SpmmConfig(tile_m=1024, window_k=4096, block_k=128, group_blocks=8)
           if fmt == "mxu" else tx.SpmmConfig())
    op = tx.spmm_value_op(coo, n, config=cfg, fmt=fmt, device=cuda)
    rng = np.random.default_rng(12)
    m, k = coo.shape
    vals = torch.tensor(coo.vals, device=cuda, requires_grad=True)
    b = torch.tensor(rng.standard_normal((k, n)), dtype=torch.float32, device=cuda,
                     requires_grad=True)
    c = torch.tensor(rng.standard_normal((m, n)), dtype=torch.float32, device=cuda,
                     requires_grad=True)
    al = torch.tensor(ALPHA, device=cuda, requires_grad=True)
    be = torch.tensor(BETA, device=cuda, requires_grad=True)
    g = torch.tensor(rng.standard_normal((m, n)), dtype=torch.float32, device=cuda)
    before = launches(sddmm_rows)
    out = op(vals, b, c, al, be)
    out.backward(g)
    torch.cuda.synchronize()
    assert launches(sddmm_rows) - before == 1
    alpha32 = float(np.float32(ALPHA))
    with torch.no_grad():
        rows, cols = op.rows, op.cols
        exact = torch.empty(coo.nnz, dtype=torch.float64, device=cuda)
        for e0 in range(0, coo.nnz, 65536):
            e1 = min(coo.nnz, e0 + 65536)
            exact[e0:e1] = (g[rows[e0:e1]].double() * b[cols[e0:e1]].double()).sum(dim=1)
        dvals64 = alpha32 * exact
        ab = op.ab(vals, b)
    unit = np.spacing(np.float32(dvals64.abs().max().item()))
    assert (vals.grad.double() - dvals64).abs().max().item() <= 4 * unit
    at = coo.transpose()
    csr_t = tx.CSRMatrix.from_coo(at)
    r = device_full_check(b.grad, csr_t, g, ALPHA, 0.0, None)
    assert r["max_abs_vs_f64"] <= 4 * np.spacing(np.float32(r["c_max_abs"]))
    assert torch.equal(c.grad, be.detach() * g)
    g64, c64 = g.double(), c.detach().double()
    dalpha64 = (vals.detach().double() * exact).sum().item()
    assert abs(al.grad.item() - dalpha64) <= 2.0**-20 * (g64 * ab.double()).abs().sum().item()
    gc = g64 * c64
    assert abs(be.grad.item() - gc.sum().item()) <= 2.0**-20 * gc.abs().sum().item()
    assert torch.isfinite(vals.grad).all() and torch.isfinite(b.grad).all()
