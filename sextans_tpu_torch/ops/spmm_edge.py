"""SpMM over the edge-stream pack (format/pack_edge.py).

``spmm_edge_padded`` is the twin of ``sextans_tpu.ops.spmm_edge_pallas``'s
``spmm_edge_padded`` (kernel K4): on a CUDA tensor it launches the
hand-written kernel in ``csrc/spmm_edge.cu``; on a CPU tensor it runs the
plain PyTorch version ``spmm_edge_padded_ref``. Any other device raises.
Both take ``precise`` (``SpmmConfig.precise``): 1 and 2 run the TPU
kernel's compensated levels, with ``ops/df32.py`` in the plain version; 2
adds a check of each element's rounding, and sums the elements it is not
sure of again from f64, so that each is the f32 nearest to its exact value.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from sextans_tpu_torch.format.pack_edge import COL_SHIFT, PAD_BIT, ROW_END, ROW_SHIFT
from sextans_tpu_torch.ops.df32 import (
    acc_step,
    acc_step_bounded,
    add_rows_bounded,
    add_rows_compensated,
    checked_epilogue,
    compensated_epilogue,
    nearest_epilogue,
    two_prod,
    two_sum,
)
from sextans_tpu_torch.ops.launch import (
    Launch,
    PackHost,
    add_rows_in_order,
    check_csr,
    check_dense,
    check_in_place,
    check_int32,
    check_owner_tiles,
    csr_ptr,
    f32,
    fma_f32,
    need,
    stream_of,
)
from sextans_tpu_torch.runtime.build import build_kernels, check_launch
from sextans_tpu_torch.utils.profiling import annotate, count

__all__ = ["spmm_edge_padded", "spmm_edge_padded_ref", "edge_launch", "row_runs",
           "check_edge_pack", "COL_MASK", "EDGE_HOST", "edge_runner", "edge_in_place"]

# The column field of an edge's meta word, after the shift by COL_SHIFT.
COL_MASK = (1 << (ROW_SHIFT - COL_SHIFT)) - 1

# Bytes of one temporary (the edge products) per chunk of chunks of the plain
# version: at cant_like N = 512 an unchunked gather would be ~8 GB. Precise
# mode, whose steps cost launches per chunk, holds ~8 such temporaries in
# 1 GB.
_REF_CHUNK_BYTES = 256 << 20
_REF_PRECISE_CHUNK_BYTES = 1 << 30
# CTAs of 256 threads an SM of level 2's second kernel, whose warps deal
# out the listed elements: at its 40 registers six fit an SM, one wave
_NEAREST_CTAS_PER_SM = 6


def spmm_edge_padded_ref(
    vals: torch.Tensor,  # (chunks, 1, E) f32
    meta: torch.Tensor,  # (chunks, 1, E) i32
    chunk_mtile: torch.Tensor,  # (chunks+1,) i32
    chunk_kwin: torch.Tensor,  # (chunks,) i32
    b_padded: torch.Tensor,  # (k_padded, n) f32
    c_padded: torch.Tensor,  # (m_padded, n) f32
    alpha: float,
    beta: float,
    *,
    tile_m: int,
    window_k: int,
    edge_chunk: int,
    masked: bool = False,
    with_c: bool = True,
    precise: int = 0,
    m: Optional[int] = None,
    k: Optional[int] = None,
) -> torch.Tensor:
    """Plain PyTorch version, rounding as the kernel does: decode the meta
    words into (row, B row) indices; sum each row run (the edges up to and
    including a ``row_end`` slot) with one fused multiply-add per edge, in
    pack order, from zero; add the run sums into their rows in pack order;
    then ``fma(alpha, acc, beta * C)``. With ``masked`` a pad slot is
    skipped; without it, it adds ``0 * B``, which changes a sum only where B
    is not finite. Works in chunks of chunks so that its temporaries stay
    bounded. B may come padded to whole K-windows or at its K rows, C padded
    to m_padded or at its M rows: the result has C's rows (``m`` and ``k``,
    the kernel wrapper's, change nothing here).

    With ``precise`` each run is a compensated pair: per edge the product
    (level 2 with its ``two_prod`` error) goes in by ``acc_step``; each
    flush is an ``acc_step`` of the run's sum into its row's pair, in pack
    order, and then adds the run's compensation; the epilogue is the
    compensated one. Level 2 takes the bounded steps of ``ops/df32.py``:
    the epilogue checks each element's f32 against the bound, and sums each
    element it is not sure of again from f64
    (:func:`_nearest_elements`), so that every finite element is the f32
    nearest to its exact value."""
    nc, E = vals.shape[0], edge_chunk
    m_rows, n = c_padded.shape
    device = vals.device
    acc = torch.zeros((m_rows, n), dtype=torch.float32, device=device)
    comp = torch.zeros_like(acc) if precise else None
    bound = torch.zeros_like(acc) if precise == 2 else None
    w = meta.view(nc, E).long()
    row = chunk_mtile[:nc].long()[:, None] * tile_m + (w >> ROW_SHIFT)
    brow = chunk_kwin.long()[:, None] * window_k + ((w >> COL_SHIFT) & COL_MASK)
    end = (w & ROW_END) != 0
    real = (w & PAD_BIT) == 0
    # A run also stops at its chunk's last slot: the register does not
    # outlive its chunk. The packer forces row_end there, except in the
    # all-padding chunks of empty M-tiles, whose partial (zeros) is dropped.
    stop = end.clone()
    stop[:, -1] = True
    # B rows whose 0 * B is not 0: only they make an unmasked pad count
    nonfinite = ~torch.isfinite(b_padded).all(dim=1)
    v = vals.view(nc, E)
    if precise:
        step = max(1, _REF_PRECISE_CHUNK_BYTES // (8 * 4 * E * n))
    else:
        step = max(1, _REF_CHUNK_BYTES // (4 * E * n))
    for g0 in range(0, nc, step):
        g1 = min(nc, g0 + step)
        e_stop, e_real = stop[g0:g1].reshape(-1), real[g0:g1].reshape(-1)
        e_v, e_b = v[g0:g1].reshape(-1), brow[g0:g1].reshape(-1)
        run = torch.cumsum(e_stop, 0) - e_stop.long()
        first = torch.ones_like(e_stop)
        first[1:] = e_stop[:-1]
        pos = torch.arange(run.numel(), device=device)
        pos = pos - pos[first][run]  # place of each edge in its run
        regs = torch.zeros((int(e_stop.sum()), n), dtype=torch.float32, device=device)
        regc = torch.zeros_like(regs) if precise else None
        regb = torch.zeros_like(regs) if precise == 2 else None
        # the runs' p-th real edges, for p = 0, 1, ...: one step each
        edges = torch.nonzero(e_real).squeeze(1)
        edges = edges[torch.argsort(pos[edges], stable=True)]
        counts = torch.bincount(pos[edges]).tolist() if edges.numel() else []
        for sel in torch.split(edges, counts):
            r = run[sel]
            if not precise:
                regs[r] = fma_f32(e_v[sel, None], b_padded[e_b[sel]], regs[r])
                continue
            vb = (e_v[sel, None], b_padded[e_b[sel]])
            if precise == 1:
                regs[r], regc[r] = acc_step(regs[r], regc[r], vb[0] * vb[1])
            else:
                regs[r], regc[r], regb[r] = acc_step_bounded(regs[r], regc[r], regb[r],
                                                             *two_prod(*vb))
        if not masked:
            # an unmasked pad adds 0 * B (and, precise, its error 0 * B - p):
            # a register starts at +0 and never turns -0, so that changes
            # nothing unless B is not finite, and then makes the run NaN
            hit = ~e_real & nonfinite[e_b]
            if bool(hit.any()):
                for r in (regs, regc) if precise else (regs,):
                    r.index_put_((run[hit],), 0.0 * b_padded[e_b[hit]], accumulate=True)
        into = row[g0:g1].reshape(-1)[e_stop]
        # a row past C's (the padding of the last M-tile) holds no entry
        flush = end[g0:g1].reshape(-1)[e_stop] & (into < m_rows)
        rows = into[flush]
        if precise == 2:
            add_rows_bounded(acc, comp, bound, rows, regs[flush], regc[flush], regb[flush])
        elif precise:
            # acc_step(acc, comp, reg), then comp + regc: subtracting -regc
            # is the same add, to the bit
            add_rows_compensated(acc, comp, rows, regs[flush], -regc[flush])
        else:
            add_rows_in_order(acc, rows, regs[flush])
    cin = (beta, c_padded) if with_c else (None, None)
    if precise == 2:
        out, unsure = checked_epilogue(alpha, acc, comp, bound, *cin)
        _nearest_elements(out, unsure, v.reshape(-1), brow.reshape(-1), row.reshape(-1),
                          real.reshape(-1), b_padded, alpha, *cin)
        return out
    if precise:
        return compensated_epilogue(alpha, acc, comp, *cin)
    if not with_c:
        return acc * f32(alpha)
    return fma_f32(torch.full_like(acc, f32(alpha)), acc, c_padded * f32(beta))


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    """The card's SMs, which size the second kernel's one wave."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def _nearest_elements(out, unsure, v, brow, row, real, b_padded, alpha, beta, cin) -> None:
    """Level 2's elements whose f32 the check left unsure, in place, as the
    kernel's ``nearest_element`` sums them: each product ``v * B`` exact in
    f64, ``two_sum`` into an f64 pair over the row's real slots in pack
    order, then ``nearest_epilogue``. ``v``, ``brow``, ``row`` and ``real``
    are per slot of the pack."""
    rows, cols = torch.nonzero(unsure, as_tuple=True)
    if rows.numel() == 0:
        return
    slots = torch.nonzero(real & torch.isin(row, rows)).squeeze(1)
    srow, order = torch.sort(row[slots], stable=True)
    slots = slots[order]
    first = torch.searchsorted(srow, rows)
    count = torch.searchsorted(srow, rows, right=True) - first
    acc = torch.zeros(rows.numel(), dtype=torch.float64, device=out.device)
    comp = torch.zeros_like(acc)
    for k in range(int(count.max())):
        live = torch.nonzero(count > k).squeeze(1)
        e = slots[first[live] + k]
        t, err = two_sum(acc[live], v[e].double() * b_padded[brow[e], cols[live]].double())
        acc[live] = t
        comp[live] = comp[live] - err
    out[rows, cols] = nearest_epilogue(acc, comp, alpha, beta,
                                       None if cin is None else cin[rows, cols])


def edge_launch(n: int, m_padded: int) -> Launch:
    """The edge kernel's thread map and grid (``csrc/spmm_edge.cu``): a
    thread owns one output row at four consecutive columns (16-byte B
    loads), and ``lanes`` threads share the row. N <= 16: 4 lanes a row, so
    a warp covers 8 rows, two warps a CTA (synthetic4704's 5,120 rows make
    320 CTAs for the H100's 132 SMs). Wider: a warp a row over 128 columns,
    8 rows a CTA, one CTA column per 128 columns of N."""
    lanes, threads = (4, 64) if n <= 16 else (32, 256)
    return Launch(lanes, 4, threads, (-(-m_padded // (threads // lanes)), -(-n // (lanes * 4))))


def _check_edge_operands(vals, meta, chunk_mtile, chunk_kwin, b_padded, c_padded,
                         ranges, *, tile_m, window_k, edge_chunk, with_c, m, k):
    """Checks a launch's operands; returns ``(rows, n)``, C's and the
    output's rows and N. Without ``m`` and ``k`` B and C are padded to whole
    K-windows and M-tiles; with them B has at least ``k`` rows and C from
    ``m`` to ``m_padded``."""
    device = vals.device
    nc = vals.shape[0]
    need(vals, "vals", torch.float32, (nc, 1, edge_chunk), device)
    need(meta, "meta", torch.int32, (nc, 1, edge_chunk), device)
    need(chunk_mtile, "chunk_mtile", torch.int32, (nc + 1,), device)
    need(chunk_kwin, "chunk_kwin", torch.int32, (nc,), device)
    if m is None:
        m_padded, n = check_dense(b_padded, c_padded, tile_m=tile_m,
                                  window_k=window_k, with_c=with_c, device=device)
        rows = m_padded
    else:
        m_padded = ranges[0].shape[0] - 1
        rows, n = check_in_place(b_padded, c_padded, m=m, k=k, m_padded=m_padded,
                                 with_c=with_c, device=device)
    check_csr(ranges[0], ranges[1:], ("row_ptr", "run_start", "run_stop"), m_padded, device)
    return rows, n


def spmm_edge_padded(
    vals: torch.Tensor,
    meta: torch.Tensor,
    chunk_mtile: torch.Tensor,
    chunk_kwin: torch.Tensor,
    b_padded: torch.Tensor,
    c_padded: torch.Tensor,
    alpha: float,
    beta: float,
    *,
    tile_m: int,
    window_k: int,
    edge_chunk: int,
    ranges: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
    masked: bool = False,
    with_c: bool = True,
    precise: int = 0,
    m: Optional[int] = None,
    k: Optional[int] = None,
) -> torch.Tensor:
    """``alpha * A @ B + beta * C``; returns a result of C's rows.

    B and C come padded to whole K-windows and M-tiles, or, with ``m`` and
    ``k`` (the pack's M and K, where :func:`edge_in_place` holds), as the
    caller's: B of at least K rows, C of M to m_padded rows.

    ``ranges`` is ``(row_ptr, run_start, run_stop)`` from
    :func:`row_runs`, on the same device: the
    kernel walks each row's own runs (:func:`edge_launch`). ``masked`` is
    ``SpmmConfig.edge_masked``; ``with_c=False`` drops the C read and
    ``c_padded`` then gives the shape only. The kernel walks a run's edges
    one by one, so ``edge_lanes`` needs no argument: it changes only where
    the pack puts its pads. ``precise`` is ``SpmmConfig.precise`` (0, 1 or
    2); at 1 and 2 each row's compensation stays in registers beside its
    sum. At 2 the kernel lists the elements whose f32 its check is not sure
    of, and a second kernel sums those again from f64 (one launch of K4 in
    ``launch.spmm_edge_padded`` all the same).
    """
    with annotate("sx.kernel.spmm_edge_padded"):
        precise = int(precise)
        kw = dict(tile_m=tile_m, window_k=window_k, edge_chunk=edge_chunk,
                  with_c=with_c)
        if vals.device.type == "cpu":
            return spmm_edge_padded_ref(
                vals, meta, chunk_mtile, chunk_kwin, b_padded, c_padded, alpha,
                beta, masked=masked, precise=precise, **kw,
            )
        if vals.device.type != "cuda":
            raise ValueError(f"spmm_edge runs on cpu or cuda, not {vals.device}")
        if precise not in (0, 1, 2):
            raise ValueError(f"precise must be 0, 1 or 2, got {precise}")
        rows, n = _check_edge_operands(
            vals, meta, chunk_mtile, chunk_kwin, b_padded, c_padded, ranges, m=m, k=k, **kw)
        out = torch.empty((rows, n), dtype=torch.float32, device=vals.device)
        dense = (b_padded, out, c_padded) if with_c else (b_padded, out)
        vec = int(n % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in dense))
        go = edge_launch(n, rows)
        # level 2: the count and the list of the elements the check is not
        # sure of, room for every element (the kernel zeroes the count)
        unsure = (torch.empty(1 + rows * n, dtype=torch.int32, device=vals.device)
                  if precise == 2 else None)
        lib = build_kernels()
        with torch.cuda.device(vals.device):
            err = lib.spmm_edge_launch(
                vals.data_ptr(), meta.data_ptr(), chunk_kwin.data_ptr(),
                *(r.data_ptr() for r in ranges), b_padded.data_ptr(),
                c_padded.data_ptr() if with_c else None, out.data_ptr(),
                None if unsure is None else unsure.data_ptr(), rows, n,
                window_k, edge_chunk, float(alpha), float(beta), int(with_c),
                int(masked), precise, go.lanes, vec, go.threads, *go.grid,
                _NEAREST_CTAS_PER_SM * _sm_count(vals.device), stream_of(vals.device),
            )
        check_launch(lib, "spmm_edge", err)
        count("launch.spmm_edge_padded")
        if precise:
            count(f"launch.spmm_edge_padded.precise{precise}")
        return out


def row_runs(packed) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Each padded output row's runs, in pack order, for the edge kernel.

    A run is the stretch of slots ``[start, stop]`` (flat indices into the
    (chunks, 1, E) arrays) that one register sums before it flushes into a
    row: it ends at a ``row_end`` slot, including the flush the packer
    forces on a chunk's last slot, and starts after the previous run's end
    or at its chunk's first slot, so it never crosses a chunk. Its row is
    its M-tile's first row plus the row field of its ``row_end`` slot. Pads
    inside a run stay in it. Slots after a chunk's last ``row_end`` (the
    all-padding chunks of empty M-tiles) flush nowhere and are not listed.

    A run of pads alone (the tail of a job's last chunk, up to a chunk long,
    which the packer's forced flush adds into the tile's row 0) is cut to
    its last slot. That leaves every sum as it was to the bit: every pad
    reads column 0 of its chunk's K-window and adds ``0 * B`` of that row
    (unmasked) or nothing (masked), so the run's register stays +0 for a
    finite row and turns NaN for another, however many pads it holds; the
    same at both precise levels, where the product's error is +-0 too.

    Returns the CSR triple ``(row_ptr, run_start, run_stop)``: row ``r``'s
    runs are ``row_ptr[r]:row_ptr[r+1]``, in ascending slot order, which is
    the order in which the pack flushes them.
    """
    cfg = packed.config
    nc, E = packed.n_chunks, cfg.edge_chunk
    m_padded = packed.n_mtiles * cfg.tile_m
    check_int32(nc * E, "row_runs")
    tiles = check_owner_tiles(packed.chunk_mtile[:nc], packed.n_mtiles, "chunk_mtile")
    w = np.ascontiguousarray(packed.meta).reshape(-1).view(np.uint32)
    stop = np.flatnonzero(w & ROW_END)
    chunk = stop // E
    after_prev = np.empty_like(stop)
    after_prev[:1] = 0
    after_prev[1:] = stop[:-1] + 1
    start = np.maximum(after_prev, chunk * E)
    reals = np.concatenate([[0], np.cumsum((w & PAD_BIT) == 0)])
    start = np.where(reals[stop + 1] > reals[start], start, stop)
    row = tiles[chunk] * cfg.tile_m + (w[stop] >> ROW_SHIFT).astype(np.int64)
    order = np.argsort(row, kind="stable")
    return (csr_ptr(row, m_padded), start[order].astype(np.int32),
            stop[order].astype(np.int32))


def check_edge_pack(packed) -> None:
    """Bounds of an edge pack's meta words and chunk steering, checked once
    on the host before upload: the edge kernel trusts them for its
    addresses. ``chunk_mtile`` is checked by :func:`row_runs`."""
    cfg = packed.config
    nc, E = packed.n_chunks, cfg.edge_chunk
    if packed.vals.shape != (nc, 1, E) or packed.meta.shape != (nc, 1, E):
        raise ValueError(f"vals and meta must be ({nc}, 1, {E})")
    if packed.chunk_mtile.shape != (nc + 1,) or packed.chunk_mtile[-1] != -1:
        raise ValueError("chunk_mtile must be (chunks+1,) and end in the sentinel -1")
    if nc == 0:
        raise ValueError("an edge pack has at least one chunk per M-tile")
    if packed.chunk_kwin.min() < 0 or packed.chunk_kwin.max() >= packed.n_kwins:
        raise ValueError("chunk_kwin holds a K-window outside the padded K")
    w = packed.meta.view(np.uint32)
    if (w >> ROW_SHIFT).max() >= cfg.tile_m:
        raise ValueError(f"an edge's row is outside [0, tile_m={cfg.tile_m})")
    if ((w >> COL_SHIFT) & COL_MASK).max() >= cfg.window_k:
        raise ValueError(f"an edge's column is outside [0, window_k={cfg.window_k})")


def _edge_checked(packed, live) -> None:
    """:func:`check_edge_pack`; counts ``edge.entries`` and ``edge.slots``,
    the pack's nnz and its chunks' slots."""
    check_edge_pack(packed)
    count("edge.entries", packed.nnz)
    count("edge.slots", packed.n_chunks * packed.config.edge_chunk)


def _edge_scan(packed, live):
    """:func:`row_runs`; counts ``edge.runs`` and ``edge.rows``, its runs
    and the padded rows that have at least one: their ratio is the flushes
    a row pays."""
    ptr, start, stop = row_runs(packed)
    count("edge.runs", start.size)
    count("edge.rows", int(np.count_nonzero(np.diff(ptr))))
    return ptr, start, stop


# the pads are marked in meta: the scan reads no values
EDGE_HOST = PackHost(
    check=_edge_checked,
    arrays=lambda packed: ((packed.vals, np.float32), (packed.meta, np.int32),
                           (packed.chunk_mtile, np.int32), (packed.chunk_kwin, np.int32)),
    scan=_edge_scan)


def edge_in_place(packed) -> bool:
    """Whether ``SpmmPlan.__call__`` gives K4 the caller's B at its K rows
    and C and the output at its M rows: where every slot reads a B row
    below K (a pack from ``pack_edge`` does: its real slots read their own
    columns and its pads the first column of a K-window that holds one).
    Worked out once a pack."""
    memo = packed.__dict__.setdefault("_dev_cache", {})
    if "in_place" not in memo:
        cfg = packed.config
        nc = packed.n_chunks
        w = packed.meta.reshape(nc, -1).view(np.uint32)
        reads = (packed.chunk_kwin[:nc, None].astype(np.int64) * cfg.window_k
                 + ((w >> COL_SHIFT) & COL_MASK))
        memo["in_place"] = bool(packed.k >= 1 and reads.max() < packed.k)
    return memo["in_place"]


def edge_runner(packed, n: int, ranges, image=None):
    """K4 (backend ``edge``) bound as ``SpmmPlan`` runs it: with the pack's
    M and K where :func:`edge_in_place` holds, so that it takes B and C as
    they lie."""
    cfg = packed.config
    shape = dict(m=packed.m, k=packed.k) if edge_in_place(packed) else {}
    return functools.partial(spmm_edge_padded, tile_m=cfg.tile_m, window_k=cfg.window_k,
                             edge_chunk=cfg.edge_chunk, masked=cfg.edge_masked, ranges=ranges,
                             precise=int(cfg.precise), **shape)
