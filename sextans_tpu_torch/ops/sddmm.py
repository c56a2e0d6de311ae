"""The SDDMM of the differentiable SpMM: ``dvals[e] = G[rows[e]] . B[cols[e]]``
over A's entries (``ops/autodiff.py`` multiplies it by alpha for d/dvals).

``sddmm_rows`` launches the hand-written kernel in ``csrc/sddmm.cu`` on a
CUDA tensor, walking the tiles of the host plan
:func:`~sextans_tpu_torch.ops.launch.sddmm_tiles` (made once per op,
:func:`sddmm_plan`); on a CPU tensor it runs the plain PyTorch version
``sddmm_rows_ref``. Any other device raises.

The kernel replaces no TPU kernel: the JAX package computes the SDDMM with
XLA ops (``sextans_tpu/ops/autodiff.py:_sddmm``), as the plain version does
here, gathering both operands' rows into (entries, N) intermediates in
device memory. What bounds the kernel, and what its ring of G and B rows
in shared memory does about it, is in its source.

``sddmm_rows_walk`` is the kernel's arithmetic on the host, walking the
plan in the kernel's order of roundings: the tests hold the plan and the
kernel to it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from sextans_tpu_torch.ops.launch import (
    SddmmTiles,
    Launch,
    check_csr,
    fma_f32,
    need,
    sddmm_tiles,
    stream_of,
)
from sextans_tpu_torch.runtime.build import build_kernels, check_launch
from sextans_tpu_torch.utils.profiling import annotate, count, timed

__all__ = ["sddmm_rows", "sddmm_rows_ref", "sddmm_rows_walk", "sddmm_plan", "sddmm_launch"]

# csrc/sddmm.cu: threads a CTA, and the most lanes an entry takes
SDDMM_THREADS = 128
SDDMM_MAX_LANES = 8

SDDMM_REF_CHUNK = 65536  # bounds the plain version's (chunk, N) gathered intermediates


def sddmm_rows_ref(g: torch.Tensor, b: torch.Tensor, rows: torch.Tensor,
                   cols: torch.Tensor) -> torch.Tensor:
    """Plain version: ``g[rows[e]] . b[cols[e]]`` in f32, in chunks of
    ``SDDMM_REF_CHUNK`` entries so that the gathered (chunk, N) rows stay
    bounded: a product and a sum over N (no ``einsum``, which may lower to a
    TF32 ``bmm``)."""
    nnz = rows.numel()
    out = torch.empty(nnz, dtype=torch.float32, device=g.device)
    for e0 in range(0, nnz, SDDMM_REF_CHUNK):
        e1 = min(nnz, e0 + SDDMM_REF_CHUNK)
        out[e0:e1] = (g[rows[e0:e1]] * b[cols[e0:e1]]).sum(dim=1)
    return out


def sddmm_launch(n: int, vec: int, n_tiles: int = 1) -> Launch:
    """The kernel's thread map (``csrc/sddmm.cu``): ``lanes`` threads an
    entry (a power of two >= ceil(n / vec), at most 8), each over ``vec``
    columns of every chunk of ``lanes * vec``; 128 threads a CTA, a CTA a
    tile. The kernel sizes its ring itself: two stages of the plan's
    ``ring_rows`` rows of a chunk, at most 32 KB."""
    if n < 1:
        raise ValueError(f"sddmm_rows takes n >= 1, got {n}")
    lanes = 1
    while lanes * vec < n and lanes < SDDMM_MAX_LANES:
        lanes *= 2
    return Launch(lanes, vec, SDDMM_THREADS, (n_tiles, 1))


@timed("upload_s")
def sddmm_plan(rows: np.ndarray, cols: np.ndarray, shape, device: torch.device
               ) -> Optional[SddmmTiles]:
    """:func:`~sextans_tpu_torch.ops.launch.sddmm_tiles` of A's COO
    coordinates, uploaded to ``device`` (int32 tensors); None on the CPU,
    whose plain version walks no tiles."""
    if device.type != "cuda":
        return None
    tiles = sddmm_tiles(rows, cols, shape)
    put = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return tiles._replace(perm=None if tiles.perm is None else put(tiles.perm),
                          **{f: put(getattr(tiles, f))
                             for f in ("tile_ptr", "slot_ptr", "tile_rows", "slots", "codes")})


def _check_tiles(tiles, shape, nnz, device) -> int:
    """Check an uploaded :class:`SddmmTiles` of ``nnz`` entries as the launch
    takes it; returns its number of tiles."""
    if not isinstance(tiles, SddmmTiles):
        raise ValueError("sddmm_rows on cuda needs tiles=sddmm_plan(...) on the device")
    if tuple(tiles.shape) != tuple(shape):
        raise ValueError(f"the tiles are of a {tiles.shape} matrix, G and B give {shape}")
    n_tiles = tiles.tile_rows.shape[0]
    if tiles.codes.shape[0] != nnz:
        raise ValueError(f"the tiles hold {tiles.codes.shape[0]} entries, the coordinates {nnz}")
    check_csr(tiles.tile_ptr, (tiles.codes,), ("tile_ptr", "codes"), n_tiles, device)
    check_csr(tiles.slot_ptr, (tiles.slots,), ("slot_ptr", "slots"), n_tiles, device)
    need(tiles.tile_rows, "tile_rows", torch.int32, (n_tiles,), device)
    if tiles.perm is not None:
        need(tiles.perm, "perm", torch.int32, (nnz,), device)
    return n_tiles


def sddmm_rows(g: torch.Tensor, b: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor, *,
               tiles: Optional[SddmmTiles] = None) -> torch.Tensor:
    """``dvals[e] = g[rows[e]] . b[cols[e]]`` (f32) for the (nnz,) COO
    coordinates of an (m, k) matrix A, with ``g`` (m, N) and ``b`` (k, N).
    ``tiles`` is :func:`sddmm_plan` of the same coordinates on the same
    device; the CPU path does not read it, and the kernel reads the
    coordinates from it alone (the launch checks that it holds as many). The lanes an entry takes follow N. One launch
    where A has an entry."""
    with annotate("sx.kernel.sddmm_rows"):
        if g.device.type == "cpu":
            return sddmm_rows_ref(g, b, rows, cols)
        if g.device.type != "cuda":
            raise ValueError(f"sddmm_rows runs on cpu or cuda, not {g.device}")
        device = g.device
        if g.dim() != 2 or b.dim() != 2 or g.shape[1] != b.shape[1] or g.shape[1] == 0:
            raise ValueError("g and b must be 2-D with one number of columns, at least one")
        (m, n), k = g.shape, b.shape[0]
        need(g, "g", torch.float32, (m, n), device)
        need(b, "b", torch.float32, (k, n), device)
        if rows.shape != cols.shape or rows.dim() != 1:
            raise ValueError("rows and cols must be 1-D and of one length")
        n_tiles = _check_tiles(tiles, (m, k), rows.numel(), device)
        out = torch.empty(tiles.codes.shape[0], dtype=torch.float32, device=device)
        if n_tiles == 0:
            return out
        vec = 4 if n % 4 == 0 and g.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0 else 1
        go = sddmm_launch(n, vec, n_tiles)
        lib = build_kernels()
        with torch.cuda.device(device):
            err = lib.sddmm_tile_launch(
                g.data_ptr(), b.data_ptr(), tiles.tile_ptr.data_ptr(),
                tiles.slot_ptr.data_ptr(), tiles.tile_rows.data_ptr(), tiles.slots.data_ptr(),
                tiles.codes.data_ptr(), None if tiles.perm is None else tiles.perm.data_ptr(),
                out.data_ptr(), n_tiles, n, tiles.ring_rows, vec, go.lanes, stream_of(device))
        check_launch(lib, "sddmm_rows", err)
        count("launch.sddmm_rows")
        return out


def sddmm_rows_walk(tiles: SddmmTiles, g: torch.Tensor, b: torch.Tensor, vec: int
                    ) -> torch.Tensor:
    """The kernel's result on the host: walks the host plan ``tiles``
    (NumPy, :func:`~sextans_tpu_torch.ops.launch.sddmm_tiles`) and takes the
    kernel's roundings in its order (``csrc/sddmm.cu``): per lane and
    chunk a product and an FFMA chain over its columns, added to the lane's
    sum chunk by chunk, then the lanes' butterfly.
    For f32 ``g`` and ``b`` on the CPU."""
    n = g.shape[1]
    lanes = sddmm_launch(n, vec).lanes
    width = lanes * vec
    chunks = -(-n // width)
    nnz = tiles.codes.size
    tile_of = np.repeat(np.arange(tiles.tile_rows.size), np.diff(tiles.tile_ptr))
    base = tiles.slot_ptr[:-1][tile_of]
    g_rows = torch.as_tensor(tiles.slots[base + (tiles.codes & 0xffff)], dtype=torch.int64)
    b_rows = torch.as_tensor(tiles.slots[base + (tiles.codes >> 16)], dtype=torch.int64)

    def staged(x, idx):
        padded = torch.zeros((nnz, chunks * width), dtype=torch.float32)
        padded[:, :n] = x[idx]
        return padded.view(nnz, chunks, lanes, vec)

    x, y = staged(g, g_rows), staged(b, b_rows)
    acc = torch.zeros((nnz, lanes), dtype=torch.float32)
    for c in range(chunks):
        part = x[:, c, :, 0] * y[:, c, :, 0]
        for v in range(1, vec):
            part = fma_f32(x[:, c, :, v], y[:, c, :, v], part)
        acc = acc + part
    while acc.shape[1] > 1:
        half = acc.shape[1] // 2
        acc = acc[:, :half] + acc[:, half:]
    out = torch.empty(nnz, dtype=torch.float32)
    at = np.arange(nnz) if tiles.perm is None else tiles.perm
    out[torch.as_tensor(at, dtype=torch.int64)] = acc[:, 0]
    return out
