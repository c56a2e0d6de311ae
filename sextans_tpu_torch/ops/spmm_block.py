"""SpMM over the 8 x block_k block pack (format/pack.py).

``spmm_block_padded`` is the twin of ``sextans_tpu.ops.spmm_pallas``'s
``spmm_pallas_padded`` (kernel K3): on a CUDA tensor it launches the
hand-written kernel in ``csrc/spmm_block.cu``; on a CPU tensor it runs the
plain PyTorch version ``spmm_block_padded_ref``, the twin of
``sextans_tpu.ops.spmm_xla.spmm_xla_padded``. Any other device raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from sextans_tpu_torch.ops.launch import (
    SMEM_LIMIT,
    add_rows_in_order,
    check_operands,
    f32,
    no_tf32,
    stream_of,
)
from sextans_tpu_torch.runtime.build import build_kernels, check_launch
from sextans_tpu_torch.utils.config import round_up

__all__ = ["spmm_block_padded", "spmm_block_padded_ref", "block_tile_n"]

# Bytes of temporaries (gathered B rows + products) one chunk of groups of the
# plain version may hold: keeps it near 1 GB even on a cant-sized pack.
_REF_CHUNK_BYTES = 256 << 20


def block_tile_n(tile_m: int, n: int) -> int:
    """Columns per CUDA block: up to 64, no wider than N needs, and with the
    tile_m x tile_n f32 accumulator inside the shared-memory limit."""
    t = min(64, round_up(n, 8), SMEM_LIMIT // (4 * tile_m) // 8 * 8)
    if t < 8:
        raise ValueError(
            f"tile_m={tile_m} leaves no room for an 8-column f32 accumulator "
            f"in {SMEM_LIMIT} bytes of shared memory"
        )
    return t


def spmm_block_padded_ref(
    vals: torch.Tensor,  # (ng, 8, G*bk) f32
    qrow: torch.Tensor,  # (ng, G) i32
    bcol: torch.Tensor,  # (ng, G) i32
    group_mtile: torch.Tensor,  # (ng+1,) i32
    group_kwin: torch.Tensor,  # (ng,) i32
    b_padded: torch.Tensor,  # (k_padded, n) f32
    c_padded: torch.Tensor,  # (m_padded, n) f32
    alpha: float,
    beta: float,
    *,
    tile_m: int,
    window_k: int,
    block_k: int,
    group_blocks: int,
    with_c: bool = True,
) -> torch.Tensor:
    """Plain PyTorch version: gather each block's bk B rows, contract the
    8 x bk block against them, add the 8-row products into their stripes in
    pack order, then ``alpha * acc + beta * C``. Works in chunks of groups so
    that its temporaries stay bounded. Contractions are full f32 (see
    :func:`~sextans_tpu_torch.ops.launch.no_tf32`)."""
    no_tf32()
    ng = vals.shape[0]
    G, bk = group_blocks, block_k
    m_padded, n = c_padded.shape
    device = vals.device
    acc = torch.zeros((m_padded // 8, 8, n), dtype=torch.float32, device=device)
    vblk = vals.view(ng, 8, G, bk).permute(0, 2, 1, 3)  # (ng, G, 8, bk)
    stripe = group_mtile[:ng].long()[:, None] * (tile_m // 8) + qrow.long()
    col0 = group_kwin.long()[:, None] * window_k + bcol.long()
    jj = torch.arange(bk, device=device)
    step = max(1, _REF_CHUNK_BYTES // (4 * G * (bk + 8) * n))
    for g0 in range(0, ng, step):
        g1 = min(ng, g0 + step)
        brows = b_padded[col0[g0:g1, :, None] + jj]  # (gc, G, bk, n)
        contrib = torch.einsum("gsik,gskn->gsin", vblk[g0:g1], brows)
        add_rows_in_order(acc, stripe[g0:g1].reshape(-1), contrib.reshape(-1, 8, n))
    out = acc.view(m_padded, n) * f32(alpha)
    if with_c:
        out = out + c_padded * f32(beta)
    return out


def spmm_block_padded(
    vals: torch.Tensor,
    qrow: torch.Tensor,
    bcol: torch.Tensor,
    group_mtile: torch.Tensor,
    group_kwin: torch.Tensor,
    b_padded: torch.Tensor,
    c_padded: torch.Tensor,
    alpha: float,
    beta: float,
    *,
    tile_m: int,
    window_k: int,
    block_k: int,
    group_blocks: int,
    ranges: Tuple[torch.Tensor, torch.Tensor],
    tile_n: Optional[int] = None,
    with_c: bool = True,
) -> torch.Tensor:
    """``alpha * A @ B + beta * C`` on padded operands; returns the padded
    (m_padded, n) result.

    ``ranges`` is ``(tile_ptr, tile_groups)`` from
    :func:`~sextans_tpu_torch.ops.launch.group_ranges`, on the same device.
    ``tile_n`` is the kernel's columns per CUDA block (default
    :func:`block_tile_n`). ``with_c=False`` drops the C read; ``c_padded``
    then gives the shape only. The TPU's ``n_acc``/``chunk_unroll`` hints
    have no counterpart here.
    """
    kw = dict(tile_m=tile_m, window_k=window_k, block_k=block_k,
              group_blocks=group_blocks)
    if vals.device.type == "cpu":
        return spmm_block_padded_ref(
            vals, qrow, bcol, group_mtile, group_kwin, b_padded, c_padded,
            alpha, beta, with_c=with_c, **kw,
        )
    if vals.device.type != "cuda":
        raise ValueError(f"spmm_block runs on cpu or cuda, not {vals.device}")
    m_padded, n, n_mtiles = check_operands(
        vals, qrow, bcol, group_mtile, group_kwin, b_padded, c_padded, ranges,
        vals_shape_per_group=(8, group_blocks * block_k), tile_m=tile_m,
        window_k=window_k, group_blocks=group_blocks, with_c=with_c,
    )
    tile_n = tile_n or block_tile_n(tile_m, n)
    if not 1 <= tile_n <= 128 or 4 * tile_m * tile_n > SMEM_LIMIT:
        raise ValueError(
            f"tile_n={tile_n} must be in [1, 128] with a tile_m x tile_n f32 "
            f"accumulator ({4 * tile_m * tile_n} bytes) within {SMEM_LIMIT}"
        )
    out = torch.empty((m_padded, n), dtype=torch.float32, device=vals.device)
    lib = build_kernels()
    with torch.cuda.device(vals.device):
        err = lib.spmm_block_launch(
            vals.data_ptr(), qrow.data_ptr(), bcol.data_ptr(),
            group_kwin.data_ptr(), ranges[0].data_ptr(), ranges[1].data_ptr(),
            b_padded.data_ptr(), c_padded.data_ptr() if with_c else None,
            out.data_ptr(), n_mtiles, n, tile_m, window_k, block_k,
            group_blocks, tile_n, float(alpha), float(beta), int(with_c),
            stream_of(vals.device),
        )
    check_launch(lib, "spmm_block", err)
    spmm_block_padded.launches += 1
    return out


spmm_block_padded.launches = 0
