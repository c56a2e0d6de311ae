"""SpMM over the block_k x 128 dense-slab pack (format/pack_mxu.py).

``spmm_slab_padded`` is the twin of ``sextans_tpu.ops.spmm_mxu_pallas``'s
``spmm_mxu_padded`` (kernel K1) and ``spmm_slab_skinny_padded`` of its
``spmm_mxu_ct_padded`` (kernel K2, n <= 32). On a CUDA tensor each launches
its hand-written kernel in ``csrc/spmm_slab.cu``; on a CPU tensor both run
the one plain PyTorch version, ``spmm_slab_padded_ref``. Any other device
raises. Both kernels return C in the (M, N) layout: the TPU's transposed-C
route has no counterpart on the card.
"""

from __future__ import annotations

from typing import Tuple

import torch

from sextans_tpu_torch.ops.launch import (
    add_rows_in_order,
    check_operands,
    f32,
    no_tf32,
    stream_of,
)
from sextans_tpu_torch.runtime.build import build_kernels, check_launch

__all__ = ["spmm_slab_padded", "spmm_slab_skinny_padded", "spmm_slab_padded_ref"]

MSLAB = 128
SKINNY_MAX_N = 32

# See spmm_block._REF_CHUNK_BYTES.
_REF_CHUNK_BYTES = 256 << 20


def spmm_slab_padded_ref(
    vals: torch.Tensor,  # (ng, G*bk, 128) f32
    qm: torch.Tensor,  # (ng, G) i32
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
    """Plain PyTorch version: ``einsum`` of each (bk, 128) slab with its
    gathered bk B rows, the (128, n) products added into their 128-row slabs
    in pack order, then ``alpha * acc + beta * C``. Works in chunks of
    groups. Contractions are full f32 (see
    :func:`~sextans_tpu_torch.ops.launch.no_tf32`)."""
    no_tf32()
    ng = vals.shape[0]
    G, bk = group_blocks, block_k
    m_padded, n = c_padded.shape
    device = vals.device
    acc = torch.zeros((m_padded // MSLAB, MSLAB, n), dtype=torch.float32, device=device)
    vblk = vals.view(ng, G, bk, MSLAB)
    slab = group_mtile[:ng].long()[:, None] * (tile_m // MSLAB) + qm.long()
    col0 = group_kwin.long()[:, None] * window_k + bcol.long()
    jj = torch.arange(bk, device=device)
    step = max(1, _REF_CHUNK_BYTES // (4 * G * (bk + MSLAB) * n))
    for g0 in range(0, ng, step):
        g1 = min(ng, g0 + step)
        brows = b_padded[col0[g0:g1, :, None] + jj]  # (gc, G, bk, n)
        contrib = torch.einsum("gskm,gskn->gsmn", vblk[g0:g1], brows)
        add_rows_in_order(acc, slab[g0:g1].reshape(-1), contrib.reshape(-1, MSLAB, n))
    out = acc.view(m_padded, n) * f32(alpha)
    if with_c:
        out = out + c_padded * f32(beta)
    return out


def _launch(entry: str, vals, qm, bcol, group_mtile, group_kwin, b_padded,
            c_padded, alpha, beta, *, tile_m, window_k, block_k, group_blocks,
            ranges, with_c):
    m_padded, n, n_mtiles = check_operands(
        vals, qm, bcol, group_mtile, group_kwin, b_padded, c_padded, ranges,
        vals_shape_per_group=(group_blocks * block_k, MSLAB), tile_m=tile_m,
        window_k=window_k, group_blocks=group_blocks, with_c=with_c,
    )
    if tile_m % MSLAB or block_k % 8:
        raise ValueError("the slab format needs tile_m % 128 == 0 and block_k % 8 == 0")
    if entry == "spmm_slab_skinny_launch" and n > SKINNY_MAX_N:
        raise ValueError(f"spmm_slab_skinny takes n <= {SKINNY_MAX_N}, got {n}")
    out = torch.empty((m_padded, n), dtype=torch.float32, device=vals.device)
    lib = build_kernels()
    with torch.cuda.device(vals.device):
        err = getattr(lib, entry)(
            vals.data_ptr(), qm.data_ptr(), bcol.data_ptr(),
            group_kwin.data_ptr(), ranges[0].data_ptr(), ranges[1].data_ptr(),
            b_padded.data_ptr(), c_padded.data_ptr() if with_c else None,
            out.data_ptr(), n_mtiles, n, tile_m, window_k, block_k,
            group_blocks, float(alpha), float(beta), int(with_c),
            stream_of(vals.device),
        )
    check_launch(lib, entry, err)
    return out


def spmm_slab_padded(
    vals: torch.Tensor,
    qm: torch.Tensor,
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
    with_c: bool = True,
) -> torch.Tensor:
    """``alpha * A @ B + beta * C`` on padded operands, any n; returns the
    padded (m_padded, n) result. ``ranges`` and ``with_c`` are as in
    :func:`~sextans_tpu_torch.ops.spmm_block.spmm_block_padded`; the kernel
    takes 64 columns per CUDA block."""
    kw = dict(tile_m=tile_m, window_k=window_k, block_k=block_k,
              group_blocks=group_blocks, with_c=with_c)
    if vals.device.type == "cpu":
        return spmm_slab_padded_ref(
            vals, qm, bcol, group_mtile, group_kwin, b_padded, c_padded,
            alpha, beta, **kw,
        )
    if vals.device.type != "cuda":
        raise ValueError(f"spmm_slab runs on cpu or cuda, not {vals.device}")
    out = _launch(
        "spmm_slab_launch", vals, qm, bcol, group_mtile, group_kwin, b_padded,
        c_padded, alpha, beta, ranges=ranges, **kw,
    )
    spmm_slab_padded.launches += 1
    return out


def spmm_slab_skinny_padded(
    vals: torch.Tensor,
    qm: torch.Tensor,
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
    with_c: bool = True,
) -> torch.Tensor:
    """The same product for n <= 32, with all n columns in one CUDA block
    per 128-row slab; returns the padded (m_padded, n) result."""
    kw = dict(tile_m=tile_m, window_k=window_k, block_k=block_k,
              group_blocks=group_blocks, with_c=with_c)
    if vals.device.type == "cpu":
        if b_padded.shape[1] > SKINNY_MAX_N:
            raise ValueError(f"spmm_slab_skinny takes n <= {SKINNY_MAX_N}")
        return spmm_slab_padded_ref(
            vals, qm, bcol, group_mtile, group_kwin, b_padded, c_padded,
            alpha, beta, **kw,
        )
    if vals.device.type != "cuda":
        raise ValueError(f"spmm_slab_skinny runs on cpu or cuda, not {vals.device}")
    out = _launch(
        "spmm_slab_skinny_launch", vals, qm, bcol, group_mtile, group_kwin,
        b_padded, c_padded, alpha, beta, ranges=ranges, **kw,
    )
    spmm_slab_skinny_padded.launches += 1
    return out


spmm_slab_padded.launches = 0
spmm_slab_skinny_padded.launches = 0
