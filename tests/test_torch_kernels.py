"""Each kernel module's plain PyTorch version against its JAX counterparts.

The same packed A (packed by ``sextans_tpu`` and carried over with
``from_reference``), B, C, alpha and beta go through:

* ``spmm_block_padded_ref`` vs ``spmm_pallas_padded(interpret=True)`` and
  ``spmm_xla_padded``;
* ``spmm_slab_padded_ref`` vs ``spmm_mxu_padded(interpret=True)`` and, at
  n <= 32, the ``mxu_interpret`` plan's transposed-C route.

Tolerance: ``max|port - jax| <= 4 * spacing(f32(max|C_f64|))``, with both
passing ``verify`` against the f64 oracle: both sides are f32 sums of the
same products, taken in a different association. On CPU tensors the kernel
wrappers run the plain versions, so they are checked here too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sextans_tpu.format.coo import COOMatrix as RefCOO
from sextans_tpu.format.csr import CSRMatrix as RefCSR
from sextans_tpu.format.pack import pack as ref_pack
from sextans_tpu.format.pack_mxu import pack_mxu as ref_pack_mxu
from sextans_tpu.ops.golden import golden_spmm_exact
from sextans_tpu.ops.plan import SpmmPlan as RefPlan
from sextans_tpu.ops.spmm_mxu_pallas import spmm_mxu_padded
from sextans_tpu.ops.spmm_pallas import spmm_pallas_padded
from sextans_tpu.ops.spmm_xla import spmm_xla_padded
from sextans_tpu.utils.config import SpmmConfig as RefConfig
from sextans_tpu.utils.verify import verify
from sextans_tpu_torch.format.convert import from_reference
from sextans_tpu_torch.ops.launch import group_ranges
from sextans_tpu_torch.ops.spmm_block import (
    block_tile_n,
    spmm_block_padded,
    spmm_block_padded_ref,
)
from sextans_tpu_torch.ops.spmm_slab import (
    spmm_slab_padded,
    spmm_slab_padded_ref,
    spmm_slab_skinny_padded,
)
from sextans_tpu_torch.utils.config import round_up

ALPHA, BETA = 0.85, -2.06


def _problem(m, k, n, nnz, seed, **kw):
    coo = RefCOO.random(m, k, nnz, seed=seed, **kw)
    rng = np.random.default_rng(seed)
    b = rng.standard_normal((k, n)).astype(np.float32)
    c = rng.standard_normal((m, n)).astype(np.float32)
    return coo, b, c


def _padded(packed, b, c, n_pad):
    m, k = packed.shape
    n = b.shape[1]
    b_p = np.zeros((packed.k_padded, n_pad), np.float32)
    c_p = np.zeros((packed.m_padded, n_pad), np.float32)
    b_p[:k, :n] = b
    c_p[:m, :n] = c
    return b_p, c_p


def _torch_args(port):
    return [torch.from_numpy(getattr(port, name)) for name in
            ("vals", "qm" if hasattr(port, "qm") else "qrow", "bcol",
             "group_mtile", "group_kwin")]


def _kw(cfg):
    return dict(tile_m=cfg.tile_m, window_k=cfg.window_k,
                block_k=cfg.block_k, group_blocks=cfg.group_blocks)


def _check(port_out, jax_outs, exact):
    tol = 4 * np.spacing(np.float32(np.abs(exact).max()))
    assert verify(exact, port_out).passed
    for out in jax_outs:
        out = np.asarray(out)
        assert verify(exact, out).passed
        assert np.abs(port_out - out).max() <= tol


@pytest.mark.parametrize(
    "m,k,n,nnz,bk,with_c",
    [
        (200, 300, 24, 1500, 8, True),
        (260, 131, 40, 1800, 4, True),
        (150, 200, 16, 900, 8, False),
    ],
)
def test_block_ref_matches_pallas_and_xla(m, k, n, nnz, bk, with_c):
    coo, b, c = _problem(m, k, n, nnz, seed=m + n, banded=True, bandwidth=60)
    cfg = RefConfig(tile_m=64, window_k=128, block_k=bk, group_blocks=128 // bk)
    ref = ref_pack(coo, cfg, impl="numpy")
    port = from_reference(ref)
    beta = BETA if with_c else 0.0
    b_p, c_p = _padded(ref, b, c, 128)
    jargs = [jnp.asarray(getattr(ref, x)) for x in
             ("vals", "qrow", "bcol", "group_mtile", "group_kwin")]
    jb, jc = jnp.asarray(b_p), jnp.asarray(c_p)
    al, be = jnp.float32(ALPHA), jnp.float32(beta)
    pallas = spmm_pallas_padded(*jargs, jb, jc, al, be, tile_n=128, interpret=True,
                                with_c=with_c, **_kw(cfg))
    xla = spmm_xla_padded(*jargs, jb, jc, al, be, **_kw(cfg))
    tb = torch.from_numpy(b_p[:, :n].copy())
    tc = torch.from_numpy(c_p[:, :n].copy())
    ranges = tuple(torch.from_numpy(a) for a in group_ranges(ref.group_mtile, ref.n_mtiles))
    got = spmm_block_padded_ref(*_torch_args(port), tb, tc, ALPHA, beta,
                                with_c=with_c, **_kw(cfg)).numpy()
    # the wrapper runs the plain version on CPU tensors
    via_wrapper = spmm_block_padded(*_torch_args(port), tb, tc, ALPHA, beta,
                                    ranges=ranges, with_c=with_c, **_kw(cfg)).numpy()
    assert via_wrapper.tobytes() == got.tobytes()
    exact = golden_spmm_exact(RefCSR.from_coo(coo), b, ALPHA, beta,
                              c if with_c else None)
    _check(got[:m], [np.asarray(pallas)[:m, :n], np.asarray(xla)[:m, :n]], exact)


@pytest.mark.parametrize(
    "m,k,n,nnz,bk,with_c",
    [
        (300, 260, 40, 2000, 8, True),
        (256, 512, 130, 2500, 32, True),
        (200, 300, 48, 1200, 16, False),
    ],
)
def test_slab_ref_matches_mxu_pallas(m, k, n, nnz, bk, with_c):
    coo, b, c = _problem(m, k, n, nnz, seed=m + n)
    cfg = RefConfig(tile_m=256, window_k=256, block_k=bk, group_blocks=4)
    ref = ref_pack_mxu(coo, cfg, impl="numpy")
    port = from_reference(ref)
    beta = BETA if with_c else 0.0
    n_pad = round_up(n, 128)
    b_p, c_p = _padded(ref, b, c, n_pad)
    jargs = [jnp.asarray(getattr(ref, x)) for x in
             ("vals", "qm", "bcol", "group_mtile", "group_kwin")]
    mxu = spmm_mxu_padded(*jargs, jnp.asarray(b_p), jnp.asarray(c_p),
                          jnp.float32(ALPHA), jnp.float32(beta), tile_n=128,
                          interpret=True, with_c=with_c, **_kw(cfg))
    tb = torch.from_numpy(b_p[:, :n].copy())
    tc = torch.from_numpy(c_p[:, :n].copy())
    ranges = tuple(torch.from_numpy(a) for a in group_ranges(ref.group_mtile, ref.n_mtiles))
    got = spmm_slab_padded_ref(*_torch_args(port), tb, tc, ALPHA, beta,
                               with_c=with_c, **_kw(cfg)).numpy()
    via_wrapper = spmm_slab_padded(*_torch_args(port), tb, tc, ALPHA, beta,
                                   ranges=ranges, with_c=with_c, **_kw(cfg)).numpy()
    assert via_wrapper.tobytes() == got.tobytes()
    exact = golden_spmm_exact(RefCSR.from_coo(coo), b, ALPHA, beta,
                              c if with_c else None)
    _check(got[:m], [np.asarray(mxu)[:m, :n]], exact)


@pytest.mark.parametrize("n", [8, 16, 29])
def test_slab_skinny_ref_matches_mxu_ct_route(n):
    coo, b, c = _problem(300, 400, n, 2500, seed=n)
    cfg = RefConfig(tile_m=256, window_k=256, block_k=8, group_blocks=8)
    ref = ref_pack_mxu(coo, cfg, impl="numpy")
    port = from_reference(ref)
    # the JAX plan's n <= 32 route: spmm_mxu_ct_padded on transposed C
    jax_out = np.asarray(RefPlan(ref, n, backend="mxu_interpret")(b, ALPHA, BETA, c))
    b_p, c_p = _padded(ref, b, c, n)
    ranges = tuple(torch.from_numpy(a) for a in group_ranges(ref.group_mtile, ref.n_mtiles))
    got = spmm_slab_skinny_padded(*_torch_args(port), torch.from_numpy(b_p),
                                  torch.from_numpy(c_p), ALPHA, BETA,
                                  ranges=ranges, **_kw(cfg)).numpy()
    exact = golden_spmm_exact(RefCSR.from_coo(coo), b, ALPHA, BETA, c)
    _check(got[:300], [jax_out], exact)


def test_slab_skinny_rejects_wide_n():
    coo, b, c = _problem(128, 128, 40, 300, seed=1)
    port = from_reference(ref_pack_mxu(coo, RefConfig(tile_m=128, window_k=128,
                                                      block_k=8, group_blocks=4),
                                       impl="numpy"))
    ranges = tuple(torch.from_numpy(a) for a in group_ranges(port.group_mtile, 1))
    with pytest.raises(ValueError, match="n <= 32"):
        spmm_slab_skinny_padded(*_torch_args(port), torch.from_numpy(b),
                                torch.from_numpy(c), ALPHA, BETA, ranges=ranges,
                                tile_m=128, window_k=128, block_k=8, group_blocks=4)


def test_group_ranges_scan_any_order():
    # groups of M-tiles 2, 0, 0, 3, then an appended empty tile 1; sentinel -1
    gmt = np.array([2, 0, 0, 3, 1, -1], dtype=np.int32)
    ptr, groups = group_ranges(gmt, 5)
    assert ptr.tolist() == [0, 2, 3, 4, 5, 5]  # tile 4 has no group at all
    assert groups.tolist() == [1, 2, 4, 0, 3]
    assert ptr.dtype == groups.dtype == np.int32
    with pytest.raises(ValueError, match="M-tile"):
        group_ranges(np.array([0, 5, -1], dtype=np.int32), 5)


def test_block_tile_n_fits_shared_memory():
    assert block_tile_n(512, 512) == 64  # 128 KB accumulator
    assert block_tile_n(512, 16) == 16
    assert block_tile_n(512, 3) == 8
    assert block_tile_n(4864, 512) == 8
    assert 4 * 1024 * block_tile_n(1024, 512) <= 232448
    with pytest.raises(ValueError, match="shared memory"):
        block_tile_n(8192, 512)


@pytest.mark.parametrize("fn", [spmm_block_padded, spmm_slab_padded,
                                spmm_slab_skinny_padded])
def test_wrappers_refuse_other_devices(fn):
    meta = torch.empty((1, 8, 8), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        fn(meta, meta, meta, meta, meta, meta, meta, 1.0, 0.0, tile_m=8,
           window_k=8, block_k=8, group_blocks=1, ranges=(meta, meta))
