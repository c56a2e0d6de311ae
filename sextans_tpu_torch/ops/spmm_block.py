"""SpMM over the 8 x block_k block pack (format/pack.py).

``spmm_block_padded`` is the twin of ``sextans_tpu.ops.spmm_pallas``'s
``spmm_pallas_padded`` (kernel K3): on a CUDA tensor it launches the
hand-written kernel in ``csrc/spmm_block.cu``; on a CPU tensor it runs the
plain PyTorch version ``spmm_block_padded_ref``, the twin of
``sextans_tpu.ops.spmm_xla.spmm_xla_padded``. Any other device raises.
Both take ``precise`` (``SpmmConfig.precise``): 1 and 2 run the TPU
kernel's compensated levels, with ``ops/df32.py`` in the plain version.
"""

from __future__ import annotations

from typing import Tuple

import torch

from sextans_tpu_torch.ops.df32 import (
    add_rows_compensated,
    compensated_epilogue,
    two_prod,
    two_sum,
)
from sextans_tpu_torch.ops.launch import (
    SMEM_LIMIT,
    Launch,
    SharedMemoryError,
    add_rows_in_order,
    check_csr,
    check_operands,
    f32,
    fma_f32,
    no_tf32,
    stream_of,
)
from sextans_tpu_torch.runtime.build import build_kernels, check_launch

__all__ = ["spmm_block_padded", "spmm_block_padded_ref", "block_launch"]

# Bytes of temporaries (gathered B rows + products) one chunk of groups of the
# plain version may hold: keeps it near 1 GB even on a cant-sized pack.
_REF_CHUNK_BYTES = 256 << 20
# The same in precise mode, whose steps cost launches per chunk: 1 GB.
_REF_PRECISE_CHUNK_BYTES = 1 << 30


# The block kernel's CTA (csrc/spmm_block.cuh: kThreads, kStage).
_CTA_THREADS = 128
_STAGED_VISITS = 256


def block_launch(n: int, n_stripes: int, precise: int = 0) -> Launch:
    """The block kernel's thread map and grid (``csrc/spmm_block.cuh``): one
    CTA of 128 threads per (stripe, column chunk), in lane groups that each
    take one visit of the stripe a round, a thread over all 8 rows at
    ``cols`` consecutive columns. N <= 16: groups of 16 lanes of one column
    (a 16-column chunk, 8 visits a round), so synthetic4704's 640 stripes
    make 640 CTAs for the H100's 132 SMs. Wider: groups of 32 lanes of four
    columns (16-byte B loads; 128 columns, 4 visits a round), so that each
    B element of a visit is loaded once per CTA. Shared memory holds two
    rounds of block sums (with their errors at level 2) and 256 staged
    visits."""
    lanes, cols = (16, 1) if n <= 16 else (32, 4)
    sums = 2 * _CTA_THREADS * 8 * cols * (2 if int(precise) == 2 else 1)
    return Launch(lanes, cols, _CTA_THREADS, (n_stripes, -(-n // (lanes * cols))),
                  4 * sums + 8 * _STAGED_VISITS)


def _block_contrib(vb: torch.Tensor, brows: torch.Tensor, precise: int):
    """The kernel's per-block sums in precise mode, ``(contrib, cerr)`` of
    shape (gc, G, 8, n) from blocks ``vb`` (gc, G, 8, bk) and their B rows
    ``brows`` (gc, G, bk, n): level 1 the FFMA chain over j from
    ``v[0] * b[0]`` (``cerr`` None); level 2 the EFT chain, with
    ``contrib + cerr`` the block's exact sum up to the rounding of
    ``cerr``."""
    terms = [(vb[..., j, None], brows[:, :, j, None, :]) for j in range(vb.shape[-1])]
    if precise >= 2:
        contrib, cerr = two_prod(*terms[0])
        for v, b in terms[1:]:
            p, pe = two_prod(v, b)
            contrib, e = two_sum(contrib, p)
            cerr = cerr + (pe + e)
        return contrib, cerr
    contrib = terms[0][0] * terms[0][1]
    for v, b in terms[1:]:
        contrib = fma_f32(v, b, contrib)
    return contrib, None


@no_tf32()
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
    precise: int = 0,
) -> torch.Tensor:
    """Plain PyTorch version: gather each block's bk B rows, contract the
    8 x bk block against them, add the 8-row products into their stripes in
    pack order, then ``alpha * acc + beta * C``. Works in chunks of groups so
    that its temporaries stay bounded. Contractions are full f32 (see
    :func:`~sextans_tpu_torch.ops.launch.no_tf32`).

    With ``precise`` it rounds as the kernel does: each block's sum by
    :func:`_block_contrib`, one Neumaier step per block visit in pack order
    (:func:`~sextans_tpu_torch.ops.df32.add_rows_compensated`), then the
    compensated epilogue."""
    ng = vals.shape[0]
    G, bk = group_blocks, block_k
    m_padded, n = c_padded.shape
    device = vals.device
    acc = torch.zeros((m_padded // 8, 8, n), dtype=torch.float32, device=device)
    comp = torch.zeros_like(acc) if precise else None
    vblk = vals.view(ng, 8, G, bk).permute(0, 2, 1, 3)  # (ng, G, 8, bk)
    stripe = group_mtile[:ng].long()[:, None] * (tile_m // 8) + qrow.long()
    col0 = group_kwin.long()[:, None] * window_k + bcol.long()
    jj = torch.arange(bk, device=device)
    if precise:  # ~14 f32-sized temporaries per product, f64 ones among them
        step = max(1, _REF_PRECISE_CHUNK_BYTES // (4 * G * (bk + 14 * 8) * n))
    else:
        step = max(1, _REF_CHUNK_BYTES // (4 * G * (bk + 8) * n))
    for g0 in range(0, ng, step):
        g1 = min(ng, g0 + step)
        brows = b_padded[col0[g0:g1, :, None] + jj]  # (gc, G, bk, n)
        rows = stripe[g0:g1].reshape(-1)
        if precise:
            contrib, cerr = _block_contrib(vblk[g0:g1], brows, precise)
            add_rows_compensated(acc, comp, rows, contrib.reshape(-1, 8, n),
                                 None if cerr is None else cerr.reshape(-1, 8, n))
            continue
        contrib = torch.einsum("gsik,gskn->gsin", vblk[g0:g1], brows)
        add_rows_in_order(acc, rows, contrib.reshape(-1, 8, n))
    if precise:
        return compensated_epilogue(alpha, acc.view(m_padded, n), comp.view(m_padded, n),
                                    beta if with_c else None, c_padded if with_c else None)
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
    with_c: bool = True,
    precise: int = 0,
) -> torch.Tensor:
    """``alpha * A @ B + beta * C`` on padded operands; returns the padded
    (m_padded, n) result.

    ``ranges`` is ``(stripe_ptr, visits)`` from
    :func:`~sextans_tpu_torch.ops.launch.stripe_visits`, on the same device:
    the kernel walks each stripe's own visits (:func:`block_launch`), and
    reads ``qrow`` and ``group_mtile`` only through them. ``with_c=False``
    drops the C read; ``c_padded`` then gives the shape only. ``precise`` is
    ``SpmmConfig.precise`` (0, 1 or 2); at 1 and 2 each cell keeps one
    compensated pair where the TPU kept ``n_acc`` of them. The TPU's
    ``n_acc``/``chunk_unroll`` hints have no counterpart here.
    """
    precise = int(precise)
    kw = dict(tile_m=tile_m, window_k=window_k, block_k=block_k,
              group_blocks=group_blocks)
    if vals.device.type == "cpu":
        return spmm_block_padded_ref(
            vals, qrow, bcol, group_mtile, group_kwin, b_padded, c_padded,
            alpha, beta, with_c=with_c, precise=precise, **kw,
        )
    if vals.device.type != "cuda":
        raise ValueError(f"spmm_block runs on cpu or cuda, not {vals.device}")
    m_padded, n = check_operands(
        vals, qrow, bcol, group_mtile, group_kwin, b_padded, c_padded,
        vals_shape_per_group=(8, group_blocks * block_k), tile_m=tile_m,
        window_k=window_k, group_blocks=group_blocks, with_c=with_c,
    )
    n_stripes = m_padded // 8
    check_csr(ranges[0], ranges[1:], ("stripe_ptr", "visits"), n_stripes, vals.device)
    if precise not in (0, 1, 2):
        raise ValueError(f"precise must be 0, 1 or 2, got {precise}")
    out = torch.empty((m_padded, n), dtype=torch.float32, device=vals.device)
    dense = (b_padded, out, c_padded) if with_c else (b_padded, out)
    vec = int(n % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in dense))
    go = block_launch(n, n_stripes, precise)
    if go.smem > SMEM_LIMIT:
        raise SharedMemoryError(f"spmm_block needs {go.smem} bytes of shared memory a CTA, "
                                f"over {SMEM_LIMIT}")
    lib = build_kernels()
    with torch.cuda.device(vals.device):
        err = lib.spmm_block_launch(
            vals.data_ptr(), bcol.data_ptr(), group_kwin.data_ptr(),
            ranges[0].data_ptr(), ranges[1].data_ptr(), b_padded.data_ptr(),
            c_padded.data_ptr() if with_c else None, out.data_ptr(), n_stripes,
            n, window_k, block_k, group_blocks, float(alpha), float(beta),
            int(with_c), precise, go.lanes, vec, go.threads, *go.grid, go.smem,
            stream_of(vals.device),
        )
    check_launch(lib, "spmm_block", err)
    spmm_block_padded.launches += 1
    return out


spmm_block_padded.launches = 0
