"""What the kernel wrappers share: the host scan of a pack's group steering,
operand checks before a launch, and the f32 rule of the plain versions."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "SMEM_LIMIT",
    "group_ranges",
    "check_pack_indices",
    "check_operands",
    "no_tf32",
    "add_rows_in_order",
    "f32",
    "stream_of",
]

# Dynamic shared memory one CUDA block may use on an H100 (sm_90), in bytes.
SMEM_LIMIT = 232448


def group_ranges(group_mtile: np.ndarray, n_mtiles: int) -> Tuple[np.ndarray, np.ndarray]:
    """Per-M-tile group ranges for the kernels, from a host scan.

    Returns ``(tile_ptr, tile_groups)``: the groups of M-tile ``t`` are
    ``tile_groups[tile_ptr[t]:tile_ptr[t+1]]``, in pack order. The scan reads
    ``group_mtile[:ng]`` (the sentinel excluded) and assumes no order: the
    packers append the groups of empty M-tiles after all real groups.
    """
    mt = np.asarray(group_mtile, dtype=np.int64)[:-1]
    if mt.size and (mt.min() < 0 or mt.max() >= n_mtiles):
        raise ValueError(f"group_mtile holds an M-tile outside [0, {n_mtiles})")
    tile_groups = np.argsort(mt, kind="stable").astype(np.int32)
    tile_ptr = np.zeros(n_mtiles + 1, dtype=np.int32)
    np.cumsum(np.bincount(mt, minlength=n_mtiles), out=tile_ptr[1:])
    return tile_ptr, tile_groups


def check_pack_indices(packed, idx: np.ndarray, idx_limit: int) -> None:
    """Bounds of a pack's steering, checked once on the host before upload:
    a kernel trusts them for its address arithmetic."""
    cfg = packed.config
    ng = packed.n_groups
    if packed.group_mtile.shape != (ng + 1,) or packed.group_kwin.shape != (ng,):
        raise ValueError("group_mtile must be (ng+1,) and group_kwin (ng,)")
    if idx.shape != (ng, cfg.group_blocks) or packed.bcol.shape != idx.shape:
        raise ValueError(f"index arrays must be ({ng}, {cfg.group_blocks})")
    if ng == 0:
        return
    if packed.group_kwin.min() < 0 or packed.group_kwin.max() >= packed.n_kwins:
        raise ValueError("group_kwin holds a K-window outside the padded K")
    if idx.min() < 0 or idx.max() >= idx_limit:
        raise ValueError(f"a block's row index is outside [0, {idx_limit})")
    if packed.bcol.min() < 0 or packed.bcol.max() + cfg.block_k > cfg.window_k:
        raise ValueError("a block's bcol runs past the end of its K-window")


def _need(t: torch.Tensor, name: str, dtype, shape: Sequence[int], device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_operands(
    vals, idx, bcol, group_mtile, group_kwin, b_padded, c_padded, ranges,
    *, vals_shape_per_group: Tuple[int, int], tile_m: int, window_k: int,
    group_blocks: int, with_c: bool,
) -> Tuple[int, int, int]:
    """Check every operand of a launch; returns ``(m_padded, n, n_mtiles)``.

    With ``with_c=False``, ``c_padded`` is used for its shape only and may be
    a broadcast view (e.g. ``torch.zeros(1).expand(m_padded, n)``).
    """
    device = vals.device
    ng = vals.shape[0]
    G = group_blocks
    _need(vals, "vals", torch.float32, (ng, *vals_shape_per_group), device)
    _need(idx, "qrow/qm", torch.int32, (ng, G), device)
    _need(bcol, "bcol", torch.int32, (ng, G), device)
    _need(group_mtile, "group_mtile", torch.int32, (ng + 1,), device)
    _need(group_kwin, "group_kwin", torch.int32, (ng,), device)
    if b_padded.dim() != 2 or c_padded.dim() != 2:
        raise ValueError("b_padded and c_padded must be 2-D")
    k_padded, n = b_padded.shape
    m_padded = c_padded.shape[0]
    if k_padded % window_k or m_padded % tile_m or m_padded == 0:
        raise ValueError(
            f"B rows {k_padded} must be a multiple of window_k {window_k}, "
            f"C rows {m_padded} a positive multiple of tile_m {tile_m}"
        )
    _need(b_padded, "b_padded", torch.float32, (k_padded, n), device)
    if with_c:
        _need(c_padded, "c_padded", torch.float32, (m_padded, n), device)
    elif tuple(c_padded.shape) != (m_padded, n):
        raise ValueError(f"c_padded must have shape {(m_padded, n)}")
    n_mtiles = m_padded // tile_m
    tile_ptr, tile_groups = ranges
    _need(tile_ptr, "tile_ptr", torch.int32, (n_mtiles + 1,), device)
    _need(tile_groups, "tile_groups", torch.int32, (ng,), device)
    if vals.data_ptr() % 16:
        raise ValueError("vals must be 16-byte aligned")
    # grid.y counts column chunks of at least 8 columns and is at most 65535
    if n == 0 or n > 65535 * 8:
        raise ValueError(f"N must be in [1, {65535 * 8}], got {n}")
    return m_padded, n, n_mtiles


def no_tf32() -> None:
    """The plain versions contract with ``einsum``; on the card that is a
    cuBLAS matmul, which would round its inputs to TF32 (10-bit mantissa)
    if allowed. The JAX package contracts at ``Precision.HIGHEST``, so both
    TF32 switches are turned off before every plain contraction."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def add_rows_in_order(acc: torch.Tensor, index: torch.Tensor, src: torch.Tensor) -> None:
    """``acc[index[i]] += src[i]`` for every i, duplicates added in i order.

    The kernels add blocks into their accumulator in pack order, so the plain
    versions do too, and the two differ only by the rounding of the block
    products and the epilogue. On the CPU ``index_add_`` runs sequentially;
    on CUDA it uses atomics in no fixed order, while ``index_put_`` with
    ``accumulate=True`` sorts the indices stably and sums each run in order.
    """
    if acc.device.type == "cuda":
        acc.index_put_((index,), src, accumulate=True)
    else:
        acc.index_add_(0, index, src)


def f32(x) -> float:
    """A scalar rounded through float32, as a kernel's ``c_float`` sees it."""
    return float(np.float32(x))


def stream_of(device: torch.device) -> Optional[int]:
    """The current CUDA stream of ``device`` as a pointer for ``ctypes``."""
    return torch.cuda.current_stream(device).cuda_stream or None
