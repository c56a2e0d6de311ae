"""Each kernel module's plain PyTorch version against its JAX counterparts.

The same packed A (packed by ``sextans_tpu`` and carried over with
``from_reference``), B, C, alpha and beta go through:

* ``spmm_block_padded_ref`` vs ``spmm_pallas_padded(interpret=True)`` and
  ``spmm_xla_padded``;
* ``spmm_slab_padded_ref`` vs ``spmm_mxu_padded(interpret=True)`` and, at
  n <= 32, the ``mxu_interpret`` plan's transposed-C route.

The block kernel's host scan (``stripe_visits``) is checked on the same
packs: every real visit listed once, in pack order within its stripe; and a
plain walk over its lists, the kernel's loop vectorised by visit rank, gives
the precise plain version's bits, with non-finite B where pad blocks read.

Tolerance: ``max|port - jax| <= 4 * spacing(f32(max|C_f64|))``, with both
passing ``verify`` against the f64 oracle: both sides are f32 sums of the
same products, taken in a different association. On CPU tensors the kernel
wrappers run the plain versions, so they are checked here too.
"""

import torch_cpu  # noqa: F401  one torch thread per xdist worker

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sextans_tpu_torch as tx
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
from sextans_tpu_torch.ops.df32 import acc_step, compensated_epilogue
from sextans_tpu_torch.ops.launch import SMEM_LIMIT
from sextans_tpu_torch.ops.spmm_block import (
    _block_contrib,
    block_launch,
    spmm_block_padded,
    spmm_block_padded_ref,
    stripe_visits,
)
from sextans_tpu_torch.ops.spmm_slab import (
    slab_visits,
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
    ranges = tuple(torch.from_numpy(a) for a in stripe_visits(port))
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
    ranges = tuple(torch.from_numpy(a) for a in slab_visits(port))
    got = spmm_slab_padded_ref(*_torch_args(port), tb, tc, ALPHA, beta,
                               with_c=with_c, **_kw(cfg)).numpy()
    via_wrapper = spmm_slab_padded(*_torch_args(port), tb, tc, ALPHA, beta, ranges=ranges,
                                   m=m, k=k, with_c=with_c, **_kw(cfg)).numpy()
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
    ranges = tuple(torch.from_numpy(a) for a in slab_visits(port))
    got = spmm_slab_skinny_padded(*_torch_args(port), torch.from_numpy(b_p),
                                  torch.from_numpy(c_p), ALPHA, BETA, ranges=ranges,
                                  m=300, k=400, **_kw(cfg)).numpy()
    exact = golden_spmm_exact(RefCSR.from_coo(coo), b, ALPHA, BETA, c)
    _check(got[:300], [jax_out], exact)


def test_slab_skinny_rejects_wide_n():
    coo, b, c = _problem(128, 128, 40, 300, seed=1)
    port = from_reference(ref_pack_mxu(coo, RefConfig(tile_m=128, window_k=128,
                                                      block_k=8, group_blocks=4),
                                       impl="numpy"))
    ranges = tuple(torch.from_numpy(a) for a in slab_visits(port))
    with pytest.raises(ValueError, match="n <= 32"):
        spmm_slab_skinny_padded(*_torch_args(port), torch.from_numpy(b),
                                torch.from_numpy(c), ALPHA, BETA, ranges=ranges, m=128,
                                k=128, tile_m=128, window_k=128, block_k=8, group_blocks=4)


def test_slab_visits_scan_any_order():
    # one slab an M-tile and one block a group: the groups, set to M-tiles
    # 2, 0, 0, 3, are the blocks of slabs 2, 0, 0, 3 (slab 1 has none); each
    # block starts at its K-window's row (group_kwin * window_k + bcol)
    coo = tx.COOMatrix((512, 32), np.array([300, 10, 140, 400]), np.array([0, 9, 17, 30]),
                       np.ones(4, np.float32))
    packed = tx.pack_mxu(coo, tx.SpmmConfig(tile_m=128, window_k=8, block_k=8,
                                            group_blocks=1))
    assert packed.n_groups == 4 and packed.group_kwin.tolist() == [1, 2, 0, 3]
    packed.group_mtile[:-1] = [2, 0, 0, 3]
    ptr, blocks, rows = slab_visits(packed)
    assert ptr.tolist() == [0, 2, 2, 3, 4]
    assert blocks.tolist() == [1, 2, 0, 3]
    assert rows.tolist() == [16, 0, 8, 24]
    assert ptr.dtype == blocks.dtype == rows.dtype == np.int32
    packed.group_mtile[0] = 4
    with pytest.raises(ValueError, match="M-tile"):
        slab_visits(packed)


def test_block_launch_spreads_over_the_card():
    # synthetic4704 pads to 5,120 rows, 640 stripes: N = 16 gives a CTA per
    # stripe, 640 for the H100's 132 SMs, 8 visits a round of 16 lanes each
    go = block_launch(16, 640)
    assert (go.lanes, go.cols, go.threads, go.grid) == (16, 1, 128, (640, 1))
    assert block_launch(1, 640) == go and block_launch(13, 640) == go
    # N = 512: 4 visits a round of a warp over 128 columns (16-byte loads)
    go = block_launch(512, 640)
    assert (go.lanes, go.cols, go.threads, go.grid) == (32, 4, 128, (640, 4))
    assert block_launch(200, 7808).grid == (7808, 2)  # cant_like's stripes
    assert block_launch(17, 3).grid == (3, 1)
    for n in (1, 13, 16, 17, 64, 200, 512, 4099):
        go = block_launch(n, 77)
        assert go.grid[0] == 77
        assert go.grid[1] * go.lanes * go.cols >= n > (go.grid[1] - 1) * go.lanes * go.cols
    # two rounds of block sums (and their errors at level 2), 256 staged
    # visits: far inside the limit, so no map is ever refused
    assert [block_launch(512, 9, p).smem for p in (0, 1, 2)] == [34816, 34816, 67584]
    assert [block_launch(16, 9, p).smem for p in (0, 2)] == [10240, 18432]
    assert max(block_launch(n, 9, 2).smem for n in (1, 512)) < SMEM_LIMIT


def _block_port(seed, bk=8, empty_tile=False):
    m, k, nnz = 200, 300, 1500
    coo = RefCOO.random(m, k, nnz, seed=seed, banded=True, bandwidth=60)
    if empty_tile:  # rows 64-127 empty: M-tile 1 gets a group of pad blocks
        keep = (coo.rows < 64) | (coo.rows >= 128)
        coo = RefCOO(coo.shape, coo.rows[keep], coo.cols[keep], coo.vals[keep])
    cfg = RefConfig(tile_m=64, window_k=128, block_k=bk, group_blocks=128 // bk)
    return from_reference(ref_pack(coo, cfg, impl="numpy"))


def _flat_stripes(port):
    cfg = port.config
    tiles = port.group_mtile[:-1].astype(np.int64)
    return (tiles[:, None] * (cfg.tile_m // 8) + port.qrow).reshape(-1)


@pytest.mark.parametrize("bk,empty_tile", [(8, False), (4, False), (8, True)])
def test_stripe_visits_list_every_real_visit_in_pack_order(bk, empty_tile):
    port = _block_port(7, bk, empty_tile)
    cfg, G = port.config, port.config.group_blocks
    ptr, visits = stripe_visits(port)
    assert ptr.dtype == visits.dtype == np.int32
    assert ptr[0] == 0 and ptr[-1] == visits.size and np.all(np.diff(ptr) >= 0)
    assert ptr.size == port.m_padded // 8 + 1
    stripe = _flat_stripes(port)
    owner = np.repeat(np.arange(ptr.size - 1), np.diff(ptr))
    assert np.array_equal(stripe[visits], owner)
    for s in range(ptr.size - 1):  # ascending flat index = pack order
        assert np.all(np.diff(visits[ptr[s]:ptr[s + 1]]) > 0)
    real = (port.vals.reshape(-1, 8, G, bk) != 0).any(axis=(1, 3)).reshape(-1)
    listed = np.zeros(real.size, bool)
    listed[visits] = True
    assert np.array_equal(listed[real], np.ones(real.sum(), bool))
    # of the all-zero visits, the first of each (stripe, K-window, bcol)
    zero = np.flatnonzero(~real)
    key = np.stack([stripe[zero], port.group_kwin[zero // G], port.bcol.reshape(-1)[zero]], 1)
    _, first = np.unique(key, axis=0, return_index=True)
    assert np.array_equal(np.flatnonzero(listed[zero]), np.sort(first))
    pads = int((~real).sum())
    assert pads > len(first) and visits.size == real.sum() + len(first)
    if empty_tile:
        assert set(stripe[zero[first]]) >= {8}  # the empty tile's stripe 0


def _walk_stripes(port, ranges, b_p, c_p, alpha, beta, precise):
    """The block kernel's loop over its lists, vectorised by visit rank:
    each stripe's r-th visit in one step, its block sum by
    ``_block_contrib``, one ``acc_step``, then the compensated epilogue."""
    cfg = port.config
    G, bk = cfg.group_blocks, cfg.block_k
    ptr, visits = ranges
    counts = np.diff(ptr)
    n = b_p.shape[1]
    acc = torch.zeros((counts.size, 8, n))
    comp = torch.zeros_like(acc)
    vblk = torch.from_numpy(port.vals).view(-1, 8, G, bk).permute(0, 2, 1, 3).reshape(-1, 8, bk)
    brow = (port.group_kwin.astype(np.int64)[:, None] * cfg.window_k + port.bcol).reshape(-1)
    for rank in range(counts.max(initial=0)):
        s = np.flatnonzero(counts > rank)
        v = visits[ptr[s] + rank]
        rows = torch.from_numpy(brow[v][:, None] + np.arange(bk))
        contrib, cerr = _block_contrib(vblk[v][None], b_p[rows][None], precise)
        acc[s], comp[s] = acc_step(acc[s], comp[s], contrib[0],
                                   None if cerr is None else cerr[0])
    return compensated_epilogue(alpha, acc.view(-1, n), comp.view(-1, n), beta, c_p)


@pytest.mark.parametrize("precise", [1, 2])
@pytest.mark.parametrize("bk,empty_tile,poison", [
    (8, False, None), (4, True, None), (8, True, np.nan), (8, True, np.inf),
    (4, False, -np.inf)])
def test_stripe_walk_gives_the_precise_plain_versions_bits(precise, bk, empty_tile, poison):
    port = _block_port(11, bk, empty_tile)
    cfg = port.config
    rng = np.random.default_rng(3)
    n = 24
    b_p = torch.from_numpy(rng.standard_normal((port.k_padded, n)).astype(np.float32))
    c_p = torch.from_numpy(rng.standard_normal((port.m_padded, n)).astype(np.float32))
    if poison is not None:  # the rows that every K-window's pad blocks read
        b_p[::cfg.window_k] = float(poison)
    ranges = stripe_visits(port)
    want = spmm_block_padded_ref(*_torch_args(port), b_p, c_p, ALPHA, BETA,
                                 precise=precise, **_kw(cfg))
    got = _walk_stripes(port, ranges, b_p, c_p, ALPHA, BETA, precise)
    assert torch.equal(torch.isfinite(got), torch.isfinite(want))
    assert torch.equal(got.nan_to_num(), want.nan_to_num())
    if poison is not None:
        assert not torch.isfinite(want).all()
        # the dropped pad visits read the same rows: the NaN rows are the
        # kept ones' stripes and the real blocks' that read row 0 of a window
        assert torch.isfinite(want).any()


@pytest.mark.parametrize("fn", [spmm_block_padded, spmm_slab_padded,
                                spmm_slab_skinny_padded])
def test_wrappers_refuse_other_devices(fn):
    meta = torch.empty((1, 8, 8), device="meta")
    shape = {} if fn is spmm_block_padded else dict(m=8, k=8)  # the slab wrappers' rows
    with pytest.raises(ValueError, match="cpu or cuda"):
        fn(meta, meta, meta, meta, meta, meta, meta, 1.0, 0.0, tile_m=8,
           window_k=8, block_k=8, group_blocks=1, ranges=(meta, meta), **shape)
