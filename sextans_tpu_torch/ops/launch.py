"""What the kernel wrappers share: the CSR helpers of the host scans, the
bounds check of the block and slab packs' steering, what ``SpmmPlan``
takes from a format's module (:class:`PackHost`), operand checks before a
launch, and the f32 rule of the plain versions. Each host scan and each
pack's own check lives in the module of the kernel that walks it."""

from __future__ import annotations

import contextlib
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "SMEM_LIMIT",
    "SharedMemoryError",
    "PackHost",
    "put",
    "put_scan",
    "csr_ptr",
    "check_owner_tiles",
    "check_int32",
    "check_pack_indices",
    "group_static",
    "need",
    "check_dense",
    "check_operands",
    "check_csr",
    "Launch",
    "no_tf32",
    "add_rows_in_order",
    "rank_groups",
    "fma_f32",
    "f32",
    "stream_of",
]

# Dynamic shared memory one CUDA block may use on an H100 (sm_90), in bytes.
SMEM_LIMIT = 232448


class SharedMemoryError(ValueError):
    """A kernel's shared-memory request does not fit in one CUDA block: the
    counterpart of the JAX package's ``check_kernel_vmem`` refusal."""


class PackHost(NamedTuple):
    """What ``SpmmPlan`` uploads of a pack format, from its kernels' module:
    ``check(packed, live)``, the bounds the kernels trust, once a pack,
    returns the pack as its plans upload it or None for the pack itself;
    ``arrays(packed)``, the ``(array, dtype)`` operands; ``scan(packed,
    live)``, the host scan the kernels walk (on a card only where
    ``cuda_only``)."""

    check: Callable
    arrays: Callable
    scan: Callable
    cuda_only: bool = False


def put(a, dtype, device):
    """``a`` as a ``dtype`` tensor on ``device``. A read-only array (a raw
    pack-cache entry, memory-mapped by ``format/pack_cache.py:_raw_load``) is
    copied on the host first: ``torch.from_numpy`` warns on it, and on the
    CPU the tensor would alias the file mapping, where a write faults. The
    copy costs one host pass over the pack, once per device; the memmap
    still saves the inflate of an ``.npz``."""
    a = np.ascontiguousarray(a, dtype=dtype)
    if not a.flags.writeable:
        a = a.copy()
    return torch.from_numpy(a).to(device)


def put_scan(scan: tuple, device) -> tuple:
    """A host scan (a tuple, or a named one) on ``device``: its arrays as
    int32 tensors, its other fields (counts, shapes, None) as they are."""
    items = [put(a, np.int32, device) if isinstance(a, np.ndarray) else a for a in scan]
    return scan._make(items) if hasattr(scan, "_make") else tuple(items)


def csr_ptr(owner: np.ndarray, n_owners: int) -> np.ndarray:
    """The int32 offsets of a CSR list whose items belong to ``owner``."""
    ptr = np.zeros(n_owners + 1, dtype=np.int32)
    np.cumsum(np.bincount(owner, minlength=n_owners), out=ptr[1:])
    return ptr


def check_owner_tiles(tiles: np.ndarray, n_mtiles: int, what: str) -> np.ndarray:
    tiles = np.asarray(tiles, dtype=np.int64)
    if tiles.size and (tiles.min() < 0 or tiles.max() >= n_mtiles):
        raise ValueError(f"{what} holds an M-tile outside [0, {n_mtiles})")
    return tiles


def check_int32(count: int, what: str) -> None:
    if count > np.iinfo(np.int32).max:
        raise ValueError(f"{what}: {count} flat indices do not fit in int32")


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


def group_static(cfg) -> dict:
    """The block and slab wrappers' static arguments, from the pack's config."""
    return dict(tile_m=cfg.tile_m, window_k=cfg.window_k, block_k=cfg.block_k,
                group_blocks=cfg.group_blocks)


def need(t: torch.Tensor, name: str, dtype, shape: Sequence[int], device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_dense(
    b_padded, c_padded, *, tile_m: int, window_k: int, with_c: bool, device,
) -> Tuple[int, int]:
    """Check the padded B and C of a launch; returns ``(m_padded, n)``.

    With ``with_c=False``, ``c_padded`` is used for its shape only and may be
    a broadcast view (e.g. ``torch.zeros(1).expand(m_padded, n)``).
    """
    if b_padded.dim() != 2 or c_padded.dim() != 2:
        raise ValueError("b_padded and c_padded must be 2-D")
    k_padded, n = b_padded.shape
    m_padded = c_padded.shape[0]
    if k_padded % window_k or m_padded % tile_m or m_padded == 0:
        raise ValueError(
            f"B rows {k_padded} must be a multiple of window_k {window_k}, "
            f"C rows {m_padded} a positive multiple of tile_m {tile_m}"
        )
    need(b_padded, "b_padded", torch.float32, (k_padded, n), device)
    if with_c:
        need(c_padded, "c_padded", torch.float32, (m_padded, n), device)
    elif tuple(c_padded.shape) != (m_padded, n):
        raise ValueError(f"c_padded must have shape {(m_padded, n)}")
    # grid.y counts column chunks of at least 8 columns and is at most 65535
    if n == 0 or n > 65535 * 8:
        raise ValueError(f"N must be in [1, {65535 * 8}], got {n}")
    return m_padded, n


def check_in_place(b, c, *, m: int, k: int, m_padded: int, with_c: bool,
                   device) -> Tuple[int, int]:
    """Check the B and C of a launch whose kernel masks the ragged edges
    itself: B of at least ``k`` rows, C from ``m`` to ``m_padded`` rows (the
    output takes C's); returns ``(rows, n)``, C's rows and N. ``c`` is as in
    :func:`check_dense`."""
    if b.dim() != 2 or c.dim() != 2:
        raise ValueError("b_padded and c_padded must be 2-D")
    rows, n = c.shape[0], b.shape[1]
    if b.shape[0] < k or not m <= rows <= m_padded:
        raise ValueError(f"B must have at least {k} rows and C from {m} to {m_padded}, "
                         f"got {tuple(b.shape)} and {tuple(c.shape)}")
    need(b, "b_padded", torch.float32, tuple(b.shape), device)
    if with_c:
        need(c, "c_padded", torch.float32, (rows, n), device)
    elif tuple(c.shape) != (rows, n):
        raise ValueError(f"c_padded must have shape {(rows, n)}")
    if n == 0 or n > 65535 * 8:
        raise ValueError(f"N must be in [1, {65535 * 8}], got {n}")
    return rows, n


def check_operands(
    vals, idx, bcol, group_mtile, group_kwin,
    *, vals_shape_per_group: Tuple[int, int], group_blocks: int,
) -> None:
    """Check the pack operands of a block or slab launch. Each wrapper
    checks its own B and C (:func:`check_dense`, :func:`check_in_place`)
    and its own ``ranges``.
    """
    device = vals.device
    ng = vals.shape[0]
    G = group_blocks
    need(vals, "vals", torch.float32, (ng, *vals_shape_per_group), device)
    need(idx, "qrow/qm", torch.int32, (ng, G), device)
    need(bcol, "bcol", torch.int32, (ng, G), device)
    need(group_mtile, "group_mtile", torch.int32, (ng + 1,), device)
    need(group_kwin, "group_kwin", torch.int32, (ng,), device)
    if vals.data_ptr() % 16:
        raise ValueError("vals must be 16-byte aligned")


class Launch(NamedTuple):
    """A thread map of the row-parallel kernels (K3, K4, K5): a lane group
    of ``lanes`` threads works on one owner (a stripe, a row or a tile),
    each thread over ``cols`` consecutive columns; ``threads`` per CTA;
    ``grid`` = (CTAs along the owners, CTAs along N); ``smem`` bytes of
    shared memory a CTA."""

    lanes: int
    cols: int
    threads: int
    grid: Tuple[int, int]
    smem: int = 0


def check_csr(ptr: torch.Tensor, items: Sequence[torch.Tensor], names: Sequence[str],
              n_owners: int, device) -> int:
    """Check a CSR list of a host scan (``slab_visits``, ``stripe_visits``,
    ``row_runs``) as a launch takes it: int32 offsets for ``n_owners``, then
    1-D int32 item arrays of one length. Returns that length."""
    need(ptr, names[0], torch.int32, (n_owners + 1,), device)
    if items[0].dim() != 1:
        raise ValueError(f"{names[1]} must be 1-D, got shape {tuple(items[0].shape)}")
    for t, name in zip(items, names[1:]):
        need(t, name, torch.int32, (items[0].shape[0],), device)
    return items[0].shape[0]


@contextlib.contextmanager
def no_tf32():
    """Both TF32 switches off inside the block, as the caller left them
    after it. The plain versions contract with ``einsum``/``matmul``; on the
    card that is a cuBLAS matmul, which would round its inputs to TF32
    (10-bit mantissa) if allowed. The JAX package contracts at
    ``Precision.HIGHEST`` and leaves global state alone, so every plain
    contraction runs inside this (``with no_tf32():``, or ``@no_tf32()`` on a
    function) and the caller's setting survives the call."""
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = matmul.allow_tf32, cudnn.allow_tf32
    matmul.allow_tf32 = cudnn.allow_tf32 = False
    try:
        yield
    finally:
        matmul.allow_tf32, cudnn.allow_tf32 = saved


def rank_groups(index: torch.Tensor):
    """The positions of ``index`` grouped by their rank among the equal
    entries before them (0 for the first visit of a row, 1 for the second,
    ...), each group ascending: one pass per rank then touches each row at
    most once, and the passes in rank order visit each row's entries in
    ``index`` order."""
    order = torch.argsort(index, stable=True)
    sorted_idx = index[order]
    pos = torch.arange(index.numel(), device=index.device)
    start = torch.ones_like(sorted_idx, dtype=torch.bool)
    start[1:] = sorted_idx[1:] != sorted_idx[:-1]
    run_start = torch.cummax(torch.where(start, pos, 0), 0).values
    rank = torch.empty_like(pos)
    rank[order] = pos - run_start
    by_rank = torch.argsort(rank, stable=True)
    return torch.split(by_rank, torch.bincount(rank).tolist())


def add_rows_in_order(acc: torch.Tensor, index: torch.Tensor, src: torch.Tensor) -> None:
    """``acc[index[i]] += src[i]`` for every i, duplicates added in i order.

    The kernels add blocks into their accumulator in pack order, so the plain
    versions do too, and the two differ only by the rounding of the block
    products and the epilogue. On the CPU ``index_add_`` runs sequentially.
    On CUDA neither it (atomics) nor ``index_put_(accumulate=True)`` keeps
    that order: on an H100 the latter sums a row's duplicates in another
    order than ``index_add_`` where a row is narrower than a warp
    (PERF.md). So there each rank of :func:`rank_groups` is one pass that
    adds into each row at most once.
    """
    if acc.device.type != "cuda":
        acc.index_add_(0, index, src)
        return
    if index.numel() == 0:
        return
    for sel in rank_groups(index):
        rows = index[sel]
        acc[rows] = acc[rows] + src[sel]


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` for f32 tensors, rounded once to f32, as a kernel's
    ``__fmaf_rn`` rounds it. The product of two f32 values is exact in f64;
    the f64 sum is rounded to odd (TwoSum recovers its error, and an inexact
    sum whose last bit is even steps one f64 ulp toward the exact value). A
    sum rounded to odd at 53 bits rounds to nearest at 24 bits as the exact
    sum does (Boldo and Melquiond), so no double rounding creeps in where
    the f64 sum lands halfway between two f32 values. Elementwise ops only,
    so it never waits for the device."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    v = s - p
    e = (p - (s - v)) + (cd - v)
    fix = (e != 0) & ((s.view(torch.int64) & 1) == 0)
    toward = torch.where(e > 0, torch.inf, -torch.inf).to(s.dtype)
    return torch.where(fix, torch.nextafter(s, toward), s).float()


def f32(x) -> float:
    """A scalar rounded through float32, as a kernel's ``c_float`` sees it."""
    return float(np.float32(x))


def stream_of(device: torch.device) -> Optional[int]:
    """The current CUDA stream of ``device`` as a pointer for ``ctypes``."""
    return torch.cuda.current_stream(device).cuda_stream or None
