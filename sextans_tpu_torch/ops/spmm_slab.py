"""SpMM over the block_k x 128 dense-slab pack (format/pack_mxu.py).

``spmm_slab_padded`` is the twin of ``sextans_tpu.ops.spmm_mxu_pallas``'s
``spmm_mxu_padded`` (kernel K1) and ``spmm_slab_skinny_padded`` of its
``spmm_mxu_ct_padded`` (kernel K2, n <= 32). On a CUDA tensor each launches
its hand-written kernel in ``csrc/spmm_slab.cu``; on a CPU tensor both run
the one plain PyTorch version, ``spmm_slab_padded_ref``. Any other device
raises. Both walk their slab's blocks (``ranges`` from
:func:`~sextans_tpu_torch.ops.launch.slab_visits`), streamed through shared
memory (:func:`slab_launch`, :func:`slab_skinny_launch`). K1 in plain mode
contracts on the tensor cores in 3xTF32 and reads the values' hi and lo
tiles made once at upload (:func:`slab_image`, ``SpmmPlan.image``). Both
kernels return C in the (M, N) layout: the TPU's transposed-C route has no
counterpart on the card. ``precise`` 1 and 2 (one level here, as in the TPU
slab kernels) contract on FFMA, compensate the sum of a block's
contraction every 8 terms (where the TPU stepped once per block visit) and
the epilogue, with ``ops/df32.py`` in the plain version.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from sextans_tpu_torch.ops.df32 import add_rows_compensated, compensated_epilogue
from sextans_tpu_torch.ops.launch import (
    SMEM_LIMIT,
    Launch,
    SharedMemoryError,
    add_rows_in_order,
    check_csr,
    check_operands,
    f32,
    need,
    no_tf32,
    stream_of,
)
from sextans_tpu_torch.runtime.build import build_kernels, check_launch
from sextans_tpu_torch.utils.config import cdiv, round_up

__all__ = ["spmm_slab_padded", "spmm_slab_skinny_padded", "spmm_slab_padded_ref",
           "slab_launch", "slab_skinny_launch", "slab_image", "tf32_rna"]

MSLAB = 128
SKINNY_MAX_N = 32
# K2's CTA (csrc/spmm_slab.cu: kSlabRows, kStages): half a slab, and a ring
# of two blocks in shared memory
SKINNY_ROWS = 64
SKINNY_STAGES = 2
SLAB_THREADS = 128  # a warpgroup


# K1's tiles (csrc/spmm_slab.cu: kChunk, kStagesK1, kTileN, kBPad): a ring
# of four stages of 32 terms of a block (block_k if fewer); 64 columns a
# warpgroup, B rows at a stride of the tile's columns + 8 floats
SLAB_CHUNK = 32
SLAB_STAGES = 4
SLAB_TILE_N = 64
SLAB_B_PAD = 8
# the tensor cores take a whole slab by 128 columns a CTA where the grid
# still fills the card four times over, else half a slab by 64 columns
SLAB_WIDE_CTAS = 4 * 132


def slab_launch(n: int, n_slabs: int, block_k: int, precise: int = 0) -> Launch:
    """K1's tiles, thread map and grid (``csrc/spmm_slab.cu``). Plain mode
    contracts on the tensor cores: a CTA of W warpgroups (128 W threads)
    per H half slabs (64 H rows) and 64 W columns, (H, W) = (2, 2) where
    ``n_slabs * ceil(n / 128)`` CTAs fill the card four times over, else
    (1, 1); a stage holds a chunk of 32 terms of a block, its hi and lo
    tiles for the CTA's rows (:func:`slab_image`) and its 32 B rows at the
    CTA's columns. Precise mode contracts on FFMA: 128 threads per half slab
    and 64 columns, each over 8 rows and 4 columns; a stage holds the
    chunk's values for the half slab and its B rows. Either way a ring of
    four stages, each beside an 8-byte mbarrier, and the column tiles of a
    slab adjacent in the grid. ``lanes`` is the rows and ``cols`` the
    columns of a CTA. A stage holds at most 32 terms whatever block_k, so
    the ring always fits a CTA: at most 200,736 bytes."""
    if n < 1:
        raise ValueError(f"spmm_slab takes n >= 1, got {n}")
    if block_k % 8:
        raise ValueError(f"spmm_slab takes block_k % 8 == 0, got {block_k}")
    ch = min(SLAB_CHUNK, block_k)
    tc = not precise
    wide = tc and n_slabs * cdiv(n, 2 * SLAB_TILE_N) >= SLAB_WIDE_CTAS
    rows, cols = (MSLAB, 2 * SLAB_TILE_N) if wide else (SKINNY_ROWS, SLAB_TILE_N)
    values = 2 * rows if tc else rows  # floats of a term: hi and lo tiles, or the values
    smem = SLAB_STAGES * (4 * ch * (values + cols + SLAB_B_PAD) + 8)
    ctas = n_slabs * (MSLAB // rows) * cdiv(n, cols)
    if ctas >= 2**31:
        raise ValueError(f"spmm_slab: {ctas} CTAs exceed the grid")
    threads = 2 * SLAB_THREADS if wide else SLAB_THREADS
    return Launch(rows, cols, threads, (ctas, 1), smem)


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """``x`` (f32) rounded to TF32 (10 stored mantissa bits), to nearest
    with ties away from zero, as ``cvt.rna.tf32.f32`` rounds it: add half a
    unit of the 13 dropped bits to the magnitude bits, then clear them. A
    finite x never carries into the sign; one that rounds past the largest
    finite value becomes infinite, as the instruction makes it."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def slab_image(vals: torch.Tensor, block_k: int) -> torch.Tensor:
    """K1's operand tiles of the slab pack's values, made once where the
    pack is uploaded. Each block (flat index ``g * G + i``) is cut into
    chunks of ``ch = min(32, block_k)`` terms, each chunk into its two half
    slabs, and each of those into the hi tile ``tf32_rna(v)`` and the lo
    tile ``tf32_rna(v - hi)``, laid out as the tensor cores read a K-major
    operand without swizzle: per 8-term step ``ks``, 8 groups of 8 rows by
    the step's two halves by 4 terms, so that ``vals[blk, ch c + 8 ks + 4
    kc + e, 64 half + 8 ng + r]`` sits at ``[blk, c, half, hi/lo, ks, ng,
    kc, r, e]``. A stage of the kernel is then one contiguous run. Returns
    an f32 tensor (blocks, block_k / ch, 2, 2, ch / 8, 512) on the values'
    device: twice the values' bytes."""
    if block_k % 8:
        raise ValueError(f"slab_image needs block_k % 8 == 0, got {block_k}")
    ch = min(SLAB_CHUNK, block_k)
    # blk, c, ks, kc, e, half, ng, r -> blk, c, half, ks, ng, kc, r, e
    v = vals.reshape(-1, block_k // ch, ch // 8, 2, 4, 2, 8, 8)
    v = v.permute(0, 1, 5, 2, 6, 3, 7, 4).contiguous()
    hi = tf32_rna(v)
    lo = tf32_rna(v - hi)
    return torch.stack((hi, lo), dim=3).reshape(-1, block_k // ch, 2, 2, ch // 8, 512)


def slab_skinny_launch(n: int, n_slabs: int, block_k: int) -> Launch:
    """K2's thread map and grid (``csrc/spmm_slab.cu``): one CTA per half
    slab (64 rows), 32 * ceil(n / 4) threads, each over 2 rows and 4
    columns (``lanes`` = 32 row pairs a column quad, ``cols`` = 4); a ring
    of two stages in shared memory, each one block's (bk, 64) values and bk
    B rows of n floats rounded up to 4, beside one 8-byte mbarrier a
    stage. Raises :class:`SharedMemoryError` where the ring does
    not fit in a CTA (never at a config's block_k <= 128: 96 KB at N =
    32)."""
    if not 1 <= n <= SKINNY_MAX_N:
        raise ValueError(f"spmm_slab_skinny takes 1 <= n <= {SKINNY_MAX_N}, got {n}")
    smem = SKINNY_STAGES * (4 * block_k * (SKINNY_ROWS + round_up(n, 4)) + 8)
    if smem > SMEM_LIMIT:
        raise SharedMemoryError(
            f"spmm_slab_skinny: {SKINNY_STAGES} stages of block_k={block_k} blocks at "
            f"N={n} need {smem} bytes of shared memory, more than the {SMEM_LIMIT} of a CTA")
    return Launch(SKINNY_ROWS // 2, 4, 32 * cdiv(n, 4),
                  (n_slabs * (MSLAB // SKINNY_ROWS), 1), smem)

# See spmm_block._REF_CHUNK_BYTES and _REF_PRECISE_CHUNK_BYTES.
_REF_CHUNK_BYTES = 256 << 20
_REF_PRECISE_CHUNK_BYTES = 1 << 30


@no_tf32()
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
    precise: int = 0,
) -> torch.Tensor:
    """Plain PyTorch version: ``einsum`` of each (bk, 128) slab with its
    gathered bk B rows, the (128, n) products added into their 128-row slabs
    in pack order, then ``alpha * acc + beta * C``. With ``precise`` each
    block's contraction is cut into bk / 8 contractions of 8 terms, each
    goes in by one Neumaier step in pack order, and the epilogue is the
    compensated one. Works in chunks of groups. Contractions are full f32
    (see :func:`~sextans_tpu_torch.ops.launch.no_tf32`)."""
    ng = vals.shape[0]
    G, bk = group_blocks, block_k
    m_padded, n = c_padded.shape
    device = vals.device
    acc = torch.zeros((m_padded // MSLAB, MSLAB, n), dtype=torch.float32, device=device)
    comp = torch.zeros_like(acc) if precise else None
    vblk = vals.view(ng, G, bk, MSLAB)
    slab = group_mtile[:ng].long()[:, None] * (tile_m // MSLAB) + qm.long()
    col0 = group_kwin.long()[:, None] * window_k + bcol.long()
    jj = torch.arange(bk, device=device)
    if precise:  # sub contractions a block, ~8 f32-sized temporaries each
        sub = max(1, bk // 8)
        step = max(1, _REF_PRECISE_CHUNK_BYTES // (4 * G * (bk + 8 * MSLAB * sub) * n))
    else:
        step = max(1, _REF_CHUNK_BYTES // (4 * G * (bk + MSLAB) * n))
    for g0 in range(0, ng, step):
        g1 = min(ng, g0 + step)
        gc = g1 - g0
        brows = b_padded[col0[g0:g1, :, None] + jj]  # (gc, G, bk, n)
        if precise:
            contrib = torch.einsum("gsukm,gsukn->gsumn",
                                   vblk[g0:g1].reshape(gc, G, sub, bk // sub, MSLAB),
                                   brows.view(gc, G, sub, bk // sub, n))  # (gc, G, sub, 128, n)
            rows = slab[g0:g1, :, None].expand(gc, G, sub).reshape(-1)
            add_rows_compensated(acc, comp, rows, contrib.reshape(-1, MSLAB, n))
        else:
            contrib = torch.einsum("gskm,gskn->gsmn", vblk[g0:g1], brows)
            add_rows_in_order(acc, slab[g0:g1].reshape(-1), contrib.reshape(-1, MSLAB, n))
    if precise:
        return compensated_epilogue(alpha, acc.view(m_padded, n), comp.view(m_padded, n),
                                    beta if with_c else None, c_padded if with_c else None)
    out = acc.view(m_padded, n) * f32(alpha)
    if with_c:
        out = out + c_padded * f32(beta)
    return out


def _launch(entry: str, vals, qm, bcol, group_mtile, group_kwin, b_padded,
            c_padded, alpha, beta, *, tile_m, window_k, block_k, group_blocks,
            ranges, with_c, precise, image=None):
    m_padded, n = check_operands(
        vals, qm, bcol, group_mtile, group_kwin, b_padded, c_padded,
        vals_shape_per_group=(group_blocks * block_k, MSLAB), tile_m=tile_m,
        window_k=window_k, group_blocks=group_blocks, with_c=with_c,
    )
    if tile_m % MSLAB or block_k % 8:
        raise ValueError("the slab format needs tile_m % 128 == 0 and block_k % 8 == 0")
    if precise not in (0, 1, 2):
        raise ValueError(f"precise must be 0, 1 or 2, got {precise}")
    skinny = entry == "spmm_slab_skinny_launch"
    n_slabs = m_padded // MSLAB
    n_blocks = vals.shape[0] * group_blocks
    # slab_visits lists every block once (the kernels skip the parked ones)
    if check_csr(ranges[0], ranges[1:], ("slab_ptr", "slab_blocks", "slab_rows"), n_slabs,
                 vals.device) != n_blocks:
        raise ValueError(f"slab_blocks must list the {n_blocks} blocks")
    if skinny:
        go = slab_skinny_launch(n, n_slabs, block_k)
    else:
        go = slab_launch(n, n_slabs, block_k, precise)
        halves = 0 if precise else go.lanes // SKINNY_ROWS
        if halves:  # the tensor cores read the operand tiles made at upload
            ch = min(SLAB_CHUNK, block_k)
            if image is None:
                raise ValueError("spmm_slab needs image=slab_image(vals, block_k) on a CUDA "
                                 "device in plain mode")
            need(image, "image", torch.float32, (n_blocks, block_k // ch, 2, 2, ch // 8, 512),
                 vals.device)
    out = torch.empty((m_padded, n), dtype=torch.float32, device=vals.device)
    lib = build_kernels()
    c_ptr = c_padded.data_ptr() if with_c else None
    b_vec = n % 4 == 0 and b_padded.data_ptr() % 16 == 0
    with torch.cuda.device(vals.device):
        if skinny:
            err = lib.spmm_slab_skinny_launch(
                vals.data_ptr(), *(r.data_ptr() for r in ranges), b_padded.data_ptr(), c_ptr,
                out.data_ptr(), n_slabs, n, block_k, float(alpha), float(beta), int(with_c),
                precise, int(b_vec), go.threads, go.grid[0], go.smem, stream_of(vals.device))
        else:
            err = lib.spmm_slab_launch(
                vals.data_ptr(), image.data_ptr() if halves else None,
                *(r.data_ptr() for r in ranges), b_padded.data_ptr(), c_ptr, out.data_ptr(),
                n_slabs, n, block_k, float(alpha), float(beta), int(with_c), precise,
                int(b_vec), halves, go.threads, go.grid[0], go.smem, stream_of(vals.device))
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
    ranges: Tuple[torch.Tensor, ...],
    image: Optional[torch.Tensor] = None,
    with_c: bool = True,
    precise: int = 0,
) -> torch.Tensor:
    """``alpha * A @ B + beta * C`` on padded operands, any n; returns the
    padded (m_padded, n) result. ``ranges`` is the slab's blocks
    (:func:`~sextans_tpu_torch.ops.launch.slab_visits`); on a CUDA device
    ``image`` is :func:`slab_image` of ``vals`` (the plain version on the
    CPU does not read it). ``with_c`` and ``precise`` are as in
    :func:`~sextans_tpu_torch.ops.spmm_block.spmm_block_padded`."""
    kw = dict(tile_m=tile_m, window_k=window_k, block_k=block_k,
              group_blocks=group_blocks, with_c=with_c, precise=int(precise))
    if vals.device.type == "cpu":
        return spmm_slab_padded_ref(
            vals, qm, bcol, group_mtile, group_kwin, b_padded, c_padded,
            alpha, beta, **kw,
        )
    if vals.device.type != "cuda":
        raise ValueError(f"spmm_slab runs on cpu or cuda, not {vals.device}")
    out = _launch(
        "spmm_slab_launch", vals, qm, bcol, group_mtile, group_kwin, b_padded,
        c_padded, alpha, beta, ranges=ranges, image=image, **kw,
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
    ranges: Tuple[torch.Tensor, ...],
    with_c: bool = True,
    precise: int = 0,
) -> torch.Tensor:
    """The same product for n <= 32, with all n columns in one CUDA block
    per half slab, over the slab's blocks (``ranges`` =
    :func:`~sextans_tpu_torch.ops.launch.slab_visits`); returns the padded
    (m_padded, n) result."""
    kw = dict(tile_m=tile_m, window_k=window_k, block_k=block_k,
              group_blocks=group_blocks, with_c=with_c, precise=int(precise))
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
