"""The port's edge-stream engine against the JAX package's, on the CPU.

The same edge pack (packed by ``sextans_tpu`` and carried over with
``from_reference``), B, C, alpha = 0.85 and beta = -2.06 go through the
port's ``edge`` backend (on CPU tensors, the plain version
``spmm_edge_padded_ref``) and the JAX package's ``edge_interpret`` backend
(the Pallas kernel K4 in interpret mode). Tolerance: ``max|port - jax| <= 4 *
spacing(f32(max|C_f64|))``, with both passing ``verify`` against the f64
oracle: both sides sum the same f32 products per row run and add the runs in
pack order, with and without fused multiply-adds.

The edge kernel's host scan (``row_runs``) is checked on the same packs:
every real slot in one run, runs inside one chunk and ending on
``row_end``, in pack order within their row, every flush kept, runs of pads
alone cut to one slot and non-flushing tails left out; and a plain walk over its lists, the kernel's loop vectorised by run
and slot rank with ``fma_f32``, gives ``spmm_edge_padded_ref``'s bits at
every precise level, with non-finite B where the pads read.
"""

import torch_cpu  # noqa: F401  one torch thread per xdist worker

import numpy as np
import pytest
import torch

import sextans_tpu_torch as tx
from sextans_tpu.format.coo import COOMatrix as RefCOO
from sextans_tpu.format.csr import CSRMatrix as RefCSR
from sextans_tpu.format.pack_edge import pack_edge as ref_pack_edge
from sextans_tpu.ops.golden import golden_spmm_exact
from sextans_tpu.ops.plan import SpmmPlan as RefPlan
from sextans_tpu.utils.config import SpmmConfig as RefConfig
from sextans_tpu_torch.format.convert import from_reference
from sextans_tpu_torch.format.pack_edge import COL_SHIFT, PAD_BIT, ROW_END, ROW_SHIFT
from sextans_tpu_torch.ops.df32 import (
    acc_step,
    acc_step_bounded,
    checked_epilogue,
    compensated_epilogue,
    nearest_epilogue,
    two_prod,
    two_sum,
)
from sextans_tpu_torch.ops.launch import fma_f32
from sextans_tpu_torch.ops.spmm_edge import (
    COL_MASK,
    check_edge_pack,
    edge_launch,
    row_runs,
    spmm_edge_padded,
    spmm_edge_padded_ref,
)

ALPHA, BETA = 0.85, -2.06
CFG = dict(tile_m=64, window_k=64, edge_chunk=32)


def _dense_rows():
    # three long rows straddle several chunks; a sprinkle of short rows
    rng = np.random.default_rng(6)
    rows = np.concatenate([np.repeat([1, 2, 70], 90), rng.integers(0, 150, 120)])
    cols = np.concatenate([np.tile(rng.permutation(120)[:90], 3),
                           rng.integers(0, 120, 120)])
    vals = rng.standard_normal(rows.size).astype(np.float32)
    return RefCOO((150, 120), rows, cols, vals)


MATRICES = {
    "random": lambda: RefCOO.random(150, 130, 500, seed=1),
    "dense_rows": _dense_rows,
    "empty_mtiles": lambda: RefCOO((200, 90), np.arange(40) % 30,
                                   np.arange(40) * 2 % 90,
                                   np.linspace(-1, 1, 40).astype(np.float32)),
}


def _operands(m, k, n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((k, n)).astype(np.float32),
            rng.standard_normal((m, n)).astype(np.float32))


def _tol(x):
    return 4 * np.spacing(np.float32(np.abs(x).max()))


def _packs(coo, **kw):
    pk = dict(reorder_cols=kw.pop("reorder_cols", False),
              reorder_rows_=kw.pop("reorder_rows_", False))
    ref = ref_pack_edge(coo, RefConfig(**CFG, **kw), impl="numpy", **pk)
    return ref, from_reference(ref)


@pytest.mark.parametrize(
    "matrix,n,lanes,reorder,with_c",
    [
        ("random", 24, 1, False, True),
        ("random", 13, 4, False, True),
        ("dense_rows", 16, 1, False, True),
        ("dense_rows", 8, 4, False, False),
        ("empty_mtiles", 24, 2, False, True),
        ("random", 16, 1, True, True),
    ],
)
def test_edge_matches_jax_interpret(matrix, n, lanes, reorder, with_c):
    coo = MATRICES[matrix]()
    ref, port = _packs(coo, edge_lanes=lanes, reorder_cols=reorder, reorder_rows_=reorder)
    b, c = _operands(*coo.shape, n)
    beta, cin = (BETA, c) if with_c else (0.0, None)
    want = np.asarray(RefPlan(ref, n, backend="edge_interpret")(b, ALPHA, beta, cin))
    got = tx.plan(port, n, "edge", device="cpu")(b, ALPHA, beta, cin)
    assert got.device.type == "cpu" and got.shape == (coo.shape[0], n)
    got = got.numpy()
    exact = golden_spmm_exact(RefCSR.from_coo(coo), b, ALPHA, beta, cin)
    assert tx.verify(exact, got).passed and tx.verify(exact, want).passed
    assert np.abs(got - want).max() <= _tol(exact)
    assert np.abs(got - exact).max() <= _tol(exact)


def test_edge_lanes_change_only_padding():
    coo = MATRICES["dense_rows"]()
    b, c = _operands(*coo.shape, 16, seed=2)
    outs = []
    for lanes in (1, 2, 4, 8):
        _, port = _packs(coo, edge_lanes=lanes)
        outs.append(tx.plan(port, 16, "edge", device="cpu")(b, ALPHA, BETA, c).numpy())
    exact = golden_spmm_exact(RefCSR.from_coo(coo), b, ALPHA, BETA, c)
    for out in outs:
        assert np.abs(out - outs[0]).max() <= _tol(exact)
        assert np.abs(out - exact).max() <= _tol(exact)


def test_edge_repeat_matches_jax():
    coo = MATRICES["random"]()
    ref, port = _packs(coo, edge_lanes=2, reorder_rows_=True)
    b, c = _operands(*coo.shape, 16, seed=4)
    want = np.asarray(RefPlan(ref, 16, backend="edge_interpret")
                      .repeat(b, ALPHA, BETA, c, times=3))
    pl = tx.plan(port, 16, "edge", device="cpu")
    got = pl.repeat(b, ALPHA, BETA, c, times=3).numpy()
    assert np.abs(got - want).max() <= _tol(want)
    step = c
    for _ in range(3):
        step = pl(b, ALPHA, BETA, step).numpy()
    assert np.abs(got - step).max() <= _tol(step)


def test_edge_empty_matrix_gives_beta_c():
    empty = RefCOO((100, 70), np.empty(0, np.int64), np.empty(0, np.int64),
                   np.empty(0, np.float32))
    ref, port = _packs(empty)
    assert port.n_chunks == port.n_mtiles == 2
    b, c = _operands(100, 70, 8)
    b[0] = np.inf  # the all-padding chunks never flush, so nothing leaks
    got = tx.plan(port, 8, "edge", device="cpu")(b, ALPHA, BETA, c).numpy()
    assert got.tobytes() == (c * np.float32(BETA)).tobytes()
    want = np.asarray(RefPlan(ref, 8, backend="edge_interpret")(b, ALPHA, BETA, c))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("masked", [True, False])
def test_edge_masked_pads_and_nonfinite_b(masked):
    # rows and columns from 1 on: only pad slots read B's row 0
    rng = np.random.default_rng(3)
    m, k, n = 64, 96, 16
    rows = rng.integers(1, m, 300)
    cols = rng.integers(1, k, 300)
    vals = rng.standard_normal(300).astype(np.float32)
    vals[vals == 0] = 1.0
    coo = RefCOO((m, k), rows, cols, vals)
    cfg = dict(tile_m=32, window_k=32, edge_chunk=64)
    ref = ref_pack_edge(coo, RefConfig(**cfg, edge_lanes=2, edge_masked=masked),
                        impl="numpy")
    port = from_reference(ref)
    assert port.config.edge_masked == masked
    b, c = _operands(m, k, n, seed=5)
    b[0] = np.inf
    want = np.asarray(RefPlan(ref, n, backend="edge_interpret")(b, ALPHA, BETA, c))
    got = tx.plan(port, n, "edge", device="cpu")(b, ALPHA, BETA, c).numpy()
    b_clean = b.copy()
    b_clean[0] = 0.0
    exact = golden_spmm_exact(RefCSR.from_coo(coo), b_clean, ALPHA, BETA, c)
    finite, jax_finite = np.isfinite(got), np.isfinite(want)
    assert finite.all() == masked == jax_finite.all()
    # Unmasked, a pad's 0 * Inf poisons its own row run here; the TPU
    # kernel's multiplicative register reset (0 * NaN) also carries it into
    # the later runs of the chunk, so it has at least these NaN rows.
    assert not (~finite & jax_finite).any()
    both = finite & jax_finite
    assert np.abs(got[both] - want[both]).max() <= _tol(exact)
    assert np.abs(got[finite] - exact[finite]).max() <= _tol(exact)
    if masked:
        assert tx.verify(exact, got).passed


def test_edge_wrapper_runs_plain_version_on_cpu():
    coo = MATRICES["dense_rows"]()
    _, port = _packs(coo)
    pl = tx.plan(port, 24, "edge", device="cpu")
    b, c = _operands(*coo.shape, 24)
    b_p, c_p = pl.pad_b(b), pl.pad_c(c)
    kw = dict(tile_m=CFG["tile_m"], window_k=CFG["window_k"],
              edge_chunk=CFG["edge_chunk"])
    via = spmm_edge_padded(*pl.arrays, b_p, c_p, ALPHA, BETA, ranges=pl.ranges, **kw)
    ref = spmm_edge_padded_ref(*pl.arrays, b_p, c_p, ALPHA, BETA, **kw)
    assert torch.equal(via, ref)
    assert [t.tolist() for t in pl.ranges] == [a.tolist() for a in row_runs(port)]
    meta = torch.empty((1, 1, 8), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        spmm_edge_padded(meta, meta, meta, meta, meta, meta, 1.0, 0.0,
                         ranges=(meta, meta), tile_m=8, window_k=8, edge_chunk=8)


@pytest.mark.parametrize(
    "field,mutate,match",
    [
        ("meta", lambda a: a.__setitem__((0, 0, 0), 70 << 17), "row"),
        ("meta", lambda a: a.__setitem__((0, 0, 0), 65 << 2), "column"),
        ("chunk_kwin", lambda a: a.__setitem__(0, 9), "K-window"),
        ("chunk_mtile", lambda a: a.__setitem__(-1, 0), "sentinel"),
    ],
)
def test_edge_pack_bounds_checked_before_upload(field, mutate, match):
    _, port = _packs(MATRICES["random"]())
    arr = getattr(port, field).copy()
    mutate(arr)
    setattr(port, field, arr)
    with pytest.raises(ValueError, match=match):
        check_edge_pack(port)
    with pytest.raises(ValueError, match=match):
        tx.SpmmPlan(port, 8, "edge", device="cpu")


SCAN_CASES = [("random", 1, False), ("dense_rows", 4, False), ("dense_rows", 1, True),
              ("empty_mtiles", 2, False), ("empty_mtiles", 4, True)]


@pytest.mark.parametrize("matrix,lanes,masked", SCAN_CASES)
def test_row_runs_cover_every_real_slot_in_pack_order(matrix, lanes, masked):
    _, port = _packs(MATRICES[matrix](), edge_lanes=lanes, edge_masked=masked)
    E, tm = CFG["edge_chunk"], CFG["tile_m"]
    ptr, start, stop = row_runs(port)
    assert ptr.dtype == start.dtype == stop.dtype == np.int32
    assert ptr.size == port.m_padded + 1 and ptr[-1] == start.size == stop.size
    w = port.meta.reshape(-1).view(np.uint32)
    assert np.all(start <= stop) and np.array_equal(start // E, stop // E)  # one chunk
    assert np.all(w[stop] & ROW_END)
    owner = np.repeat(np.arange(port.m_padded), np.diff(ptr))
    chunk_row = port.chunk_mtile[stop // E].astype(np.int64) * tm
    assert np.array_equal(chunk_row + (w[stop] >> ROW_SHIFT), owner)
    for r in np.flatnonzero(np.diff(ptr) > 1):  # pack order: ascending slots
        assert np.all(start[ptr[r] + 1:ptr[r + 1]] > stop[ptr[r]:ptr[r + 1] - 1])
    covered = np.zeros(w.size, int)
    for a, z in zip(start, stop):
        covered[a:z + 1] += 1
    assert covered.max() == 1
    inside = np.zeros(w.size, bool)  # no row_end inside a run but its last slot
    for a, z in zip(start, stop):
        inside[a:z] = True
    assert not np.any(w[inside] & ROW_END)
    real = (w & PAD_BIT) == 0
    assert np.all(covered[real] == 1) and np.all(~real[covered == 0])
    # every flush is kept: the runs' ends are the row_end slots, in order
    assert np.array_equal(np.sort(stop), np.flatnonzero(w & ROW_END))
    # a run holds a real slot or is one pad; each run starts right after
    # the previous row_end of its chunk, or is cut to its last slot
    reals = np.array([real[a:z + 1].any() for a, z in zip(start, stop)])
    assert np.all(start[~reals] == stop[~reals])
    ends = np.sort(stop)
    prev = {z: (ends[i - 1] + 1 if i and ends[i - 1] // E == z // E else z // E * E)
            for i, z in enumerate(ends)}
    assert all(a == prev[z] for a, z in zip(start[reals], stop[reals]))
    assert all(not real[prev[z]:z + 1].any() for z in stop[~reals])
    assert (~reals).any()  # each job's pad tail, cut to one slot
    if matrix == "empty_mtiles":  # the all-padding chunks flush nowhere
        assert covered.reshape(-1, E)[-1].sum() == 0


def _walk_rows(port, ranges, b_p, c_p, alpha, beta, masked, precise):
    """The edge kernel's loop over its lists, vectorised: each row's q-th
    run in one step, its t-th slot in one sub-step (``fma_f32``, or the
    product into ``acc_step`` at level 1 and ``acc_step_bounded`` at level
    2, whose bound the row keeps across its runs, pad steps included, as
    the kernel's does), the flush, then the kernel's epilogue; at level 2
    each element the check leaves unsure is summed again from f64 over its
    row's lists, slot by slot, as the kernel's ``nearest_element`` does.
    The plain version gathers its bound in another order, so at level 2
    this also holds that its outputs do not depend on which rigorous bound
    decides."""
    E, wk = CFG["edge_chunk"], CFG["window_k"]
    ptr, start, stop = ranges
    counts = np.diff(ptr)
    w = port.meta.reshape(-1).view(np.uint32)
    v = torch.from_numpy(port.vals.reshape(-1))
    brow = port.chunk_kwin.astype(np.int64)[np.arange(w.size) // E] * wk + (
        (w >> COL_SHIFT) & COL_MASK)
    pad = (w & PAD_BIT) != 0
    acc = torch.zeros((port.m_padded, b_p.shape[1]))
    comp = torch.zeros_like(acc)
    bound = torch.zeros_like(acc)
    for q in range(counts.max(initial=0)):
        rows = np.flatnonzero(counts > q)
        s0, s1 = start[ptr[rows] + q], stop[ptr[rows] + q]
        reg = torch.zeros((rows.size, b_p.shape[1]))
        regc = torch.zeros_like(reg)
        rb = torch.from_numpy(rows)
        for t in range(int((s1 - s0).max()) + 1):
            slot = s0 + t
            sel = np.flatnonzero((slot <= s1) & ~(masked & pad[np.minimum(slot, w.size - 1)]))
            slot = slot[sel]
            x, b = v[slot][:, None], b_p[brow[slot]]
            if precise == 0:
                reg[sel] = fma_f32(x, b, reg[sel])
            elif precise == 1:
                reg[sel], regc[sel] = acc_step(reg[sel], regc[sel], x * b)
            else:
                on = rb[sel]
                reg[sel], regc[sel], bound[on] = acc_step_bounded(reg[sel], regc[sel],
                                                                  bound[on], *two_prod(x, b))
        if precise == 0:
            acc[rows] = acc[rows] + reg
        elif precise == 1:
            acc[rows], comp[rows] = acc_step(acc[rows], comp[rows], reg)
            comp[rows] = comp[rows] + regc
        else:
            t, e = two_sum(acc[rb], reg)
            c1 = comp[rb] - e
            acc[rb], comp[rb] = t, c1 + regc
            bound[rb] = (bound[rb] + c1.abs()) + comp[rb].abs()
    if precise == 1:
        return compensated_epilogue(alpha, acc, comp, beta, c_p)
    if precise == 0:
        return fma_f32(torch.full_like(acc, np.float32(alpha)), acc, c_p * np.float32(beta))
    out, unsure = checked_epilogue(alpha, acc, comp, bound, beta, c_p)
    for i, j in torch.nonzero(unsure).tolist():
        pair = [0.0, 0.0]
        for q in range(ptr[i], ptr[i + 1]):
            for slot in range(start[q], stop[q] + 1):
                if not pad[slot]:
                    p = float(v[slot]) * float(b_p[brow[slot], j])  # exact in f64
                    t, e = two_sum(torch.tensor(pair[0], dtype=torch.float64),
                                   torch.tensor(p, dtype=torch.float64))
                    pair = [float(t), pair[1] - float(e)]
        out[i, j] = nearest_epilogue(*(torch.tensor([x], dtype=torch.float64) for x in pair),
                                     alpha, beta, c_p[i:i + 1, j])[0]
    return out


@pytest.mark.parametrize("precise", [0, 1, 2])
@pytest.mark.parametrize("matrix,lanes,masked", SCAN_CASES)
@pytest.mark.parametrize("poison", [None, np.nan, np.inf])
def test_row_walk_gives_the_plain_versions_bits(matrix, lanes, masked, precise, poison):
    coo = MATRICES[matrix]()
    _, port = _packs(coo, edge_lanes=lanes, edge_masked=masked)
    b, c = _operands(*coo.shape, 16, seed=7)
    pl = tx.plan(port, 16, "edge", device="cpu")
    b_p, c_p = pl.pad_b(b), pl.pad_c(c)
    if poison is not None:  # the row of each K-window that the pads read
        b_p[::CFG["window_k"]] = float(poison)
    kw = dict(tile_m=CFG["tile_m"], window_k=CFG["window_k"], edge_chunk=CFG["edge_chunk"],
              masked=masked, precise=precise)
    want = spmm_edge_padded_ref(*pl.arrays, b_p, c_p, ALPHA, BETA, **kw)
    got = _walk_rows(port, row_runs(port), b_p, c_p, ALPHA, BETA, masked, precise)
    assert torch.equal(torch.isfinite(got), torch.isfinite(want))
    assert torch.equal(got.nan_to_num(), want.nan_to_num())
    if poison is not None and not masked and lanes > 1:
        assert not torch.isfinite(want).all()  # an unmasked pad met the poison


def test_edge_launch_spreads_over_the_card():
    # synthetic4704 pads to 5,120 rows: N = 16 gives 4 lanes a row, 8 rows a
    # warp, 320 CTAs of two warps for the H100's 132 SMs
    go = edge_launch(16, 5120)
    assert (go.lanes, go.cols, go.threads, go.grid, go.smem) == (4, 4, 64, (320, 1), 0)
    assert edge_launch(1, 5120) == go and edge_launch(13, 5120) == go
    # N = 512: a warp a row over 128 columns, 8 rows a CTA, 4 column chunks
    go = edge_launch(512, 5120)
    assert (go.lanes, go.cols, go.threads, go.grid) == (32, 4, 256, (640, 4))
    assert edge_launch(200, 62464).grid == (7808, 2)  # cant_like's rows
    for n in (1, 13, 16, 17, 64, 200, 512, 4099):
        go = edge_launch(n, 64)
        assert go.grid[0] * go.threads // go.lanes >= 64
        assert go.grid[1] * go.lanes * go.cols >= n > (go.grid[1] - 1) * go.lanes * go.cols
