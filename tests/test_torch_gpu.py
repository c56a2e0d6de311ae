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

import numpy as np
import pytest
import torch

import sextans_tpu_torch as tx
from sextans_tpu_torch.ops import df32
from sextans_tpu_torch.ops.spmm_block import spmm_block_padded, spmm_block_padded_ref
from sextans_tpu_torch.ops.spmm_dia import (
    DiaRuns,
    dia_plan,
    spmm_dia,
    spmm_dia_ref,
    spmm_dia_skinny,
)
from sextans_tpu_torch.ops.spmm_edge import spmm_edge_padded, spmm_edge_padded_ref
from sextans_tpu_torch.ops.spmm_ell import spmm_ell_gather_padded, spmm_ell_gather_padded_ref
from sextans_tpu_torch.ops.launch import SharedMemoryError, dia_runs, slab_visits
from sextans_tpu_torch.ops.spmm_slab import (
    SKINNY_STAGES,
    spmm_slab_padded,
    spmm_slab_padded_ref,
    spmm_slab_skinny_padded,
)
from sextans_tpu_torch.probes import dma_gather, ell_issue
from sextans_tpu_torch.utils.matrices import circuit_like, fem_like, stencil_3d

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
    if kernel is spmm_slab_padded:  # K1's operand tiles, made where the plan uploads
        kw["image"] = pl.image
    before = kernel.launches
    got = kernel(*pl.arrays, b, c, ALPHA, BETA, ranges=pl.ranges, **kw)
    kw.pop("image", None)
    want = plain(*pl.arrays, b, c, ALPHA, BETA, **kw)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
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
               precise=0, launches=1):
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
    before = kernel.launches
    got = kernel(*pl.arrays, b, c, ALPHA, BETA, **kw, **extra)
    want = plain(*pl.arrays, b, c, ALPHA, BETA, **kw)
    torch.cuda.synchronize()
    assert kernel.launches == before + launches
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
               launches=2 if kind == "long_hub" else 1)


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
    before = kernel.launches
    got = kernel(dv, offs, b, c, ALPHA, BETA, **runs, **kw)
    want = spmm_dia_ref(dv, offs, b, c, ALPHA, BETA, **kw)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
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
    before = dia.launches
    for got in (on_card(b, ALPHA, BETA, c), on_card.repeat(b, ALPHA, BETA, c, times=1)):
        assert got.device == cuda
        got = got.cpu().numpy()
        assert tx.verify(exact, got).passed
        assert np.abs(got - on_cpu(b, ALPHA, BETA, c).numpy()).max() <= tol
    assert dia.launches == before + 2
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


def test_eft_probe_twin_on_card(cuda):
    a, b, v, bb = df32.probe_inputs(0)
    pairs_before, chain_before = df32.eft_probe_pairs.launches, df32.eft_probe_chain.launches
    ta, tb = torch.as_tensor(a, device=cuda), torch.as_tensor(b, device=cuda)
    tv, tbb = torch.as_tensor(v, device=cuda), torch.as_tensor(bb, device=cuda)
    pairs = df32.eft_probe_pairs(ta, tb)
    chain = df32.eft_probe_chain(tv, tbb)
    torch.cuda.synchronize()
    assert df32.eft_probe_pairs.launches == pairs_before + 1
    assert df32.eft_probe_chain.launches == chain_before + 1
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
    before = kernel.launches
    got = tx.plan(packed, n, backend, device=cuda)(b, ALPHA, BETA, c)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1 and got.device == cuda
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
    before = spmm_ell_gather_padded.launches
    got = tx.plan(packed, n, backend, device=cuda)(b, ALPHA, BETA, c)
    torch.cuda.synchronize()
    assert spmm_ell_gather_padded.launches == before + (backend == "ell_pallas")
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
    before = (dia.launches, residue.launches)
    got = on_card(b, ALPHA, BETA, c)
    torch.cuda.synchronize()
    assert (dia.launches, residue.launches) == (before[0] + 1, before[1] + 1)
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
    before = dma_gather.gather_spmm.launches
    got = dma_gather.gather_spmm(cols, vals, b, staging=staging, block=block)
    torch.cuda.synchronize()
    assert dma_gather.gather_spmm.launches == before + 1
    assert torch.equal(got, dma_gather.gather_spmm_ref(cols, vals, b))


@pytest.mark.parametrize("variant", ell_issue.VARIANTS)
@pytest.mark.parametrize("k,m,r,n", GATHER_SHAPES)
def test_ell_issue_kernel_equals_plain_and_keeps_pads_out(cuda, k, m, r, n, variant):
    cols, vals, b = _gather_operands(cuda, k, m, r, n, zero_share=0.3)
    cols[(vals == 0) & (torch.arange(m, device=cuda)[:, None] % 2 == 0)] = 0
    vals[3, 0], cols[3, 0] = 0.5, 0  # a nonzero slot on row 0
    want = ell_issue.ell_issue_ref(vals, cols, b)
    before = ell_issue.ell_issue.launches
    assert torch.equal(ell_issue.ell_issue(vals, cols, b, variant=variant), want)
    b[0] = float("nan")
    got = ell_issue.ell_issue(vals, cols, b, variant=variant)
    torch.cuda.synchronize()
    assert ell_issue.ell_issue.launches == before + 2
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
    before = dma_gather.gather_spmm.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        dma_gather.gather_spmm(cols, vals, shifted, staging="async")
    got = dma_gather.gather_spmm(cols, vals, shifted)
    torch.cuda.synchronize()
    assert dma_gather.gather_spmm.launches == before + 1
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
    kw = dict(tile_m=256, window_k=512, block_k=32, group_blocks=4, ranges=pl.ranges)
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
    before = spmm_slab_skinny_padded.launches
    with pytest.raises(SharedMemoryError, match="shared memory"):
        spmm_slab_skinny_padded(vals, idx, idx, torch.tensor([0, -1], **i32),
                                torch.zeros(1, **i32), b, c, 1.0, 0.0, tile_m=128,
                                window_k=bk, block_k=bk, group_blocks=1, ranges=ranges)
    assert spmm_slab_skinny_padded.launches == before


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
    before = spmm_dia.launches
    by_hand = DiaRuns(offs, torch.tensor([0, 2], dtype=torch.int32, device=cuda), 2400, 2)
    with pytest.raises(SharedMemoryError, match="shared memory"):
        spmm_dia(dv, offs, b, c, 1.0, 0.0, runs=by_hand)
    assert spmm_dia.launches == before
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
    before = kernel.launches
    with pytest.raises(ValueError, match="runs.offsets"):
        kernel(dv, offs, b, c, 1.0, 0.0, runs=runs)
    assert kernel.launches == before


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
    before = spmm_slab_padded.launches
    beta, c_in = (BETA, c) if with_c else (0.0, None)
    got = pl(b, ALPHA, beta, c_in).cpu().numpy()
    assert spmm_slab_padded.launches == before + 1
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
              image=pl.image)
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
    kw = dict(tile_m=256, window_k=256, block_k=16, group_blocks=8, ranges=pl.ranges)
    before = spmm_slab_padded.launches
    with pytest.raises(ValueError, match="image"):
        spmm_slab_padded(*pl.arrays, b, c, 1.0, 0.0, **kw)
    with pytest.raises(ValueError, match="image must have shape"):
        spmm_slab_padded(*pl.arrays, b, c, 1.0, 0.0, **kw, image=pl.image[1:])
    with pytest.raises(ValueError, match="slab_blocks"):
        spmm_slab_padded(*pl.arrays, b, c, 1.0, 0.0, **{**kw, "ranges": (
            pl.ranges[0], pl.ranges[1][1:], pl.ranges[2][1:])}, image=pl.image)
    assert spmm_slab_padded.launches == before


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
