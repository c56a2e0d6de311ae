"""The CUDA kernels against their plain PyTorch versions, on the card.

Needs a CUDA device and nvcc; skipped without a device. This file imports
no JAX, so on a machine without it run it as::

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py -q

Tolerance: ``max|kernel - plain| <= 4 * spacing(f32(max|plain|))``; both sum
the same f32 products in pack order and differ in the rounding of each
block's product and of the epilogue.
"""

import numpy as np
import pytest
import torch

import sextans_tpu_torch as tx
from sextans_tpu_torch.ops.spmm_block import spmm_block_padded, spmm_block_padded_ref
from sextans_tpu_torch.ops.spmm_slab import (
    spmm_slab_padded,
    spmm_slab_padded_ref,
    spmm_slab_skinny_padded,
)

pytestmark = pytest.mark.gpu

ALPHA, BETA = 0.85, -2.06


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


def _matrix(kind):
    if kind == "empty_mtiles":
        rng = np.random.default_rng(4)
        rows = rng.integers(0, 100, 3000)
        cols = rng.integers(0, 900, 3000)
        vals = rng.standard_normal(3000).astype(np.float32)
        return tx.COOMatrix((1100, 900), rows, cols, vals)
    return tx.COOMatrix.random(1030, 777, 12000, seed=3, banded=True, bandwidth=90)


def _check(kernel, plain, cuda, packed, n, with_c, **extra):
    pl = tx.plan(packed, n, "mxu" if hasattr(packed, "qm") else "pallas", device=cuda)
    rng = np.random.default_rng(n)
    b = pl.pad_b(rng.standard_normal((packed.k, n)).astype(np.float32))
    c = pl.pad_c(rng.standard_normal((packed.m, n)).astype(np.float32))
    if not with_c:
        c = torch.zeros(1, device=cuda).expand(packed.m_padded, n)
    cfg = packed.config
    kw = dict(tile_m=cfg.tile_m, window_k=cfg.window_k, block_k=cfg.block_k,
              group_blocks=cfg.group_blocks, with_c=with_c)
    before = kernel.launches
    got = kernel(*pl.arrays, b, c, ALPHA, BETA, ranges=pl.ranges, **kw, **extra)
    want = plain(*pl.arrays, b, c, ALPHA, BETA, **kw)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert got.shape == want.shape == (packed.m_padded, n) and got.device == cuda
    assert torch.isfinite(got).all()
    tol = 4 * np.spacing(np.float32(want.abs().max().item()))
    assert (got - want).abs().max().item() <= tol


@pytest.mark.parametrize("kind", ["banded", "empty_mtiles"])
@pytest.mark.parametrize("n", [1, 13, 64, 200])
@pytest.mark.parametrize("bk,tile_n", [(8, None), (1, 32), (32, 8)])
def test_block_kernel_matches_plain(cuda, kind, n, bk, tile_n):
    cfg = tx.SpmmConfig(tile_m=256, window_k=256, block_k=bk,
                        group_blocks=max(32, 128 // bk))
    _check(spmm_block_padded, spmm_block_padded_ref, cuda,
           tx.pack(_matrix(kind), cfg), n, with_c=n != 13, tile_n=tile_n)


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


@pytest.mark.parametrize("backend", ["pallas", "mxu", "xla"])
@pytest.mark.parametrize("n", [16, 96])
def test_plan_on_card_matches_cpu(cuda, backend, n):
    coo = _matrix("banded")
    cfg = tx.SpmmConfig(tile_m=256, window_k=256, block_k=8, group_blocks=16)
    packed = tx.pack_mxu(coo, cfg, reorder_rows_=True) if backend == "mxu" \
        else tx.pack(coo, cfg, reorder_cols=True)
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
    with pytest.raises(ValueError, match="tile_n"):
        spmm_block_padded(*pl.arrays, b, c, 1.0, 0.0, tile_n=256, **kw)
    with pytest.raises(ValueError, match="multiple of tile_m"):
        spmm_block_padded(*pl.arrays, b, c[:-8], 1.0, 0.0, **kw)
    with pytest.raises(ValueError, match="c_padded must have shape"):
        spmm_block_padded(*pl.arrays, b, c[:, :8], 1.0, 0.0, **kw)
