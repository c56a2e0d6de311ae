"""SpMM over the block_k x 128 dense-slab pack (format/pack_mxu.py).

``spmm_slab_padded`` is the twin of ``sextans_tpu.ops.spmm_mxu_pallas``'s
``spmm_mxu_padded`` (kernel K1) and ``spmm_slab_skinny_padded`` of its
``spmm_mxu_ct_padded`` (kernel K2, n <= 32). On a CUDA tensor each launches
its hand-written kernel in ``csrc/spmm_slab.cu``; on a CPU tensor both run
the one plain PyTorch version, ``spmm_slab_padded_ref``. Any other device
raises. Both walk their slab's blocks (``ranges`` from :func:`slab_visits`,
the host scan made at upload), streamed through shared memory
(:func:`slab_launch`, :func:`slab_skinny_launch`). K1 in plain mode
contracts on the tensor cores in 3xTF32 and reads the values' hi and lo
tiles made once at upload (:func:`slab_image`, ``SpmmPlan.image``). Both
kernels return C in the (M, N) layout: the TPU's transposed-C route has no
counterpart on the card. ``precise`` 1 and 2 (one level here, as in the TPU
slab kernels) contract on FFMA, compensate the sum of a block's
contraction every 8 terms (where the TPU stepped once per block visit) and
the epilogue, with ``ops/df32.py`` in the plain version.

The wrappers take B of at least ``k`` rows and C of ``m`` to m_padded
rows, and return an output of C's rows: ``SpmmPlan`` binds the pack's M and
K and hands the caller's B and C where they lie; serving and ``repeat``
hand them padded. The kernels zero B's rows past its end in shared memory
and write no row past C's, so every output row is the padded call's to the
bit.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from sextans_tpu_torch.ops.df32 import add_rows_compensated, compensated_epilogue
from sextans_tpu_torch.ops.launch import (
    SMEM_LIMIT,
    Launch,
    PackHost,
    SharedMemoryError,
    add_rows_in_order,
    check_csr,
    check_in_place,
    check_int32,
    check_operands,
    check_owner_tiles,
    check_pack_indices,
    csr_ptr,
    f32,
    group_static,
    need,
    no_tf32,
    stream_of,
)
from sextans_tpu_torch.runtime.build import build_kernels, check_launch
from sextans_tpu_torch.utils.config import cdiv, round_up
from sextans_tpu_torch.utils.profiling import annotate, count

__all__ = ["spmm_slab_padded", "spmm_slab_skinny_padded", "spmm_slab_padded_ref",
           "slab_launch", "slab_skinny_launch", "slab_image", "tf32_rna", "slab_visits",
           "SLAB_HOST", "slab_runner", "k1_image", "slab_in_place", "slab_edges"]

MSLAB = 128
SKINNY_MAX_N = 32
# K2's CTA (csrc/spmm_slab.cu: kSlabRows, kStages): half a slab, and a ring
# of two blocks in shared memory
SKINNY_ROWS = 64
SKINNY_STAGES = 2
SLAB_THREADS = 128  # a warpgroup


# K1's tiles (csrc/spmm_slab.cu: kChunk, kStagesK1, kTileN, kBPad): a ring
# of four stages of 32 terms of a block (block_k if fewer); 64 columns a
# warpgroup, B rows at a stride of those columns + 8 floats
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
    tiles for the CTA's rows (:func:`slab_image`) and each warpgroup's 32 B
    rows at its 64 columns; each warpgroup keeps one 8-term step on the
    tensor cores while it adds up the one before (the overlapped mainloop),
    and a stage is freed by a counter beside its mbarrier. Precise mode
    contracts on FFMA: 128 threads per half slab and 64 columns, each over
    8 rows and 4 columns; a stage holds the chunk's values for the half slab and its B rows. Either
    way a ring of four stages, each beside an 8-byte mbarrier, and the
    column tiles of a slab adjacent in the grid. ``lanes`` is the rows and
    ``cols`` the columns of a CTA. A stage holds at most 32 terms whatever
    block_k, so the ring always fits a CTA: at most 204,848 bytes."""
    if n < 1:
        raise ValueError(f"spmm_slab takes n >= 1, got {n}")
    if block_k % 8:
        raise ValueError(f"spmm_slab takes block_k % 8 == 0, got {block_k}")
    ch = min(SLAB_CHUNK, block_k)
    tc = not precise
    wide = tc and n_slabs * cdiv(n, 2 * SLAB_TILE_N) >= SLAB_WIDE_CTAS
    rows, cols = (MSLAB, 2 * SLAB_TILE_N) if wide else (SKINNY_ROWS, SLAB_TILE_N)
    values = 2 * rows if tc else rows  # floats of a term: hi and lo tiles, or the values
    pad = SLAB_B_PAD * (cols // SLAB_TILE_N)  # each warpgroup's B rows are padded
    smem = SLAB_STAGES * (4 * ch * (values + cols + pad) + 8 + (4 if tc else 0))
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
    b_padded: torch.Tensor,  # (k_padded, n) f32, or at least K rows
    c_padded: torch.Tensor,  # (m_padded, n) f32, or M to m_padded rows
    alpha: float,
    beta: float,
    *,
    tile_m: int,
    window_k: int,
    block_k: int,
    group_blocks: int,
    with_c: bool = True,
    precise: int = 0,
    m: Optional[int] = None,
    k: Optional[int] = None,
) -> torch.Tensor:
    """Plain PyTorch version: ``einsum`` of each (bk, 128) slab with its
    gathered bk B rows, the (128, n) products added into their 128-row slabs
    in pack order, then ``alpha * acc + beta * C``. With ``precise`` each
    block's contraction is cut into bk / 8 contractions of 8 terms, each
    goes in by one Neumaier step in pack order, and the epilogue is the
    compensated one. Works in chunks of groups. Contractions are full f32
    (see :func:`~sextans_tpu_torch.ops.launch.no_tf32`). B's rows past its
    own read as zeros, and the result has C's rows, as in the kernels
    (``m`` and ``k``, the kernel wrapper's, change nothing here)."""
    ng = vals.shape[0]
    G, bk = group_blocks, block_k
    m_rows, n = c_padded.shape
    device = vals.device
    vblk = vals.view(ng, G, bk, MSLAB)
    slab = group_mtile[:ng].long()[:, None] * (tile_m // MSLAB) + qm.long()
    col0 = group_kwin.long()[:, None] * window_k + bcol.long()
    # the slabs the blocks add into, and C's, whichever reach further; the
    # B rows they read, past B's own as zeros
    n_slabs = max(-(-m_rows // MSLAB), int(slab.max()) + 1 if ng else 0)
    b_rows = int(col0.max()) + bk if ng else 0
    if b_rows > b_padded.shape[0]:
        b_padded = F.pad(b_padded, (0, 0, 0, b_rows - b_padded.shape[0]))
    acc = torch.zeros((n_slabs, MSLAB, n), dtype=torch.float32, device=device)
    comp = torch.zeros_like(acc) if precise else None
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
    acc = acc.view(-1, n)[:m_rows]
    if precise:
        return compensated_epilogue(alpha, acc, comp.view(-1, n)[:m_rows],
                                    beta if with_c else None, c_padded if with_c else None)
    out = acc * f32(alpha)
    if with_c:
        out = out + c_padded * f32(beta)
    return out


def _launch(entry: str, vals, qm, bcol, group_mtile, group_kwin, b_padded,
            c_padded, alpha, beta, *, tile_m, window_k, block_k, group_blocks,
            ranges, with_c, precise, m, k, image=None):
    check_operands(vals, qm, bcol, group_mtile, group_kwin,
                   vals_shape_per_group=(group_blocks * block_k, MSLAB), group_blocks=group_blocks)
    n_slabs = ranges[0].shape[0] - 1  # the scan's slabs: C's rows are at most theirs
    rows, n = check_in_place(b_padded, c_padded, m=m, k=k, m_padded=n_slabs * MSLAB,
                             with_c=with_c, device=vals.device)
    if tile_m % MSLAB or block_k % 8:
        raise ValueError("the slab format needs tile_m % 128 == 0 and block_k % 8 == 0")
    if precise not in (0, 1, 2):
        raise ValueError(f"precise must be 0, 1 or 2, got {precise}")
    skinny = entry == "spmm_slab_skinny_launch"
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
        # the tensor cores' edge slabs run apart; FFMA checks every CTA's edges itself
        edges = slab_edges(ranges, m, k, block_k) if halves else None
    out = torch.empty((rows, n), dtype=torch.float32, device=vals.device)
    lib = build_kernels()
    c_ptr = c_padded.data_ptr() if with_c else None
    b_vec = n % 4 == 0 and b_padded.data_ptr() % 16 == 0
    b_rows = b_padded.shape[0]  # the kernels read B's own rows, the rest as zeros
    with torch.cuda.device(vals.device):
        if skinny:
            err = lib.spmm_slab_skinny_launch(
                vals.data_ptr(), *(r.data_ptr() for r in ranges), b_padded.data_ptr(), c_ptr,
                out.data_ptr(), n_slabs, n, rows, b_rows, block_k, float(alpha), float(beta),
                int(with_c), precise, int(b_vec), go.threads, go.grid[0], go.smem,
                stream_of(vals.device))
        else:
            n_edges = 0 if edges is None else edges.numel()
            err = lib.spmm_slab_launch(
                vals.data_ptr(), image.data_ptr() if halves else None,
                *(r.data_ptr() for r in ranges), edges.data_ptr() if n_edges else None,
                b_padded.data_ptr(), c_ptr, out.data_ptr(), n_slabs, n_edges, n, rows, b_rows,
                block_k, float(alpha), float(beta), int(with_c), precise, int(b_vec), halves,
                go.threads, go.grid[0], go.smem, stream_of(vals.device))
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
    m: int,
    k: int,
    image: Optional[torch.Tensor] = None,
    with_c: bool = True,
    precise: int = 0,
) -> torch.Tensor:
    """``alpha * A @ B + beta * C``, any n, on B of at least ``k`` rows and
    C of ``m`` to m_padded rows; returns a result of C's rows (the module
    docstring). ``ranges`` is the slab's blocks (:func:`slab_visits`); on a
    CUDA device ``image`` is :func:`slab_image` of ``vals`` (the plain
    version on the CPU does not read it). ``with_c`` and ``precise`` are as
    in :func:`~sextans_tpu_torch.ops.spmm_block.spmm_block_padded`."""
    with annotate("sx.kernel.spmm_slab_padded"):
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
            c_padded, alpha, beta, ranges=ranges, image=image, m=m, k=k, **kw,
        )
        count("launch.spmm_slab_padded")
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
    m: int,
    k: int,
    with_c: bool = True,
    precise: int = 0,
) -> torch.Tensor:
    """The same product for n <= 32, with all n columns in one CUDA block
    per half slab, over the slab's blocks (``ranges`` =
    :func:`slab_visits`); returns a result of C's rows."""
    with annotate("sx.kernel.spmm_slab_skinny_padded"):
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
            b_padded, c_padded, alpha, beta, ranges=ranges, m=m, k=k, **kw,
        )
        count("launch.spmm_slab_skinny_padded")
        return out


def slab_visits(packed, live: Optional[np.ndarray] = None
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Each 128-row slab's blocks, in pack order, for the slab kernels.

    Returns the CSR triple ``(slab_ptr, slab_blocks, slab_rows)``: the
    blocks of global slab ``s = group_mtile * tile_m / 128 + qm`` are the
    flat block indices ``g * G + i`` in ``slab_blocks[slab_ptr[s]:
    slab_ptr[s+1]]``, ascending, which is the order in which the pack adds
    them (the groups of an M-tile in group order, then the blocks of a
    group); ``slab_rows`` holds beside each the row of B where the block's
    terms start, ``group_kwin[g] * window_k + bcol[g, i]``.

    Of the blocks whose values are all zero (the pack's pad blocks, and the
    pad groups a bucket appends to the last M-tile's slab 0, ops/serve.py),
    one per distinct (slab, K-window, bcol) is kept, the first; the rest are
    dropped from the slabs' lists, as
    :func:`~sextans_tpu_torch.ops.spmm_block.stripe_visits` drops them, and
    parked after ``slab_ptr[-1]``, where no kernel reads them: so
    ``slab_blocks`` still holds every block once, and the wrappers check
    its length against the pack's. That leaves every sum as it was to the
    bit: a zero block's terms are ``0 * B`` (+-0 where its B
    rows are finite, NaN where one is not), so its block sum is +-0 or NaN,
    and adding +-0 to an accumulator that starts at +0 and is never -0
    leaves it unchanged, in the FFMA chains (K2, K1 in precise mode, a
    Neumaier step as well) and in K1's 3xTF32 steps alike; NaN sticks, and
    the kept block reads the same B rows as the dropped ones. A kernel
    visits no block twice, so a slab's chain is as long as its distinct
    blocks, however many pad groups the bucket adds.

    ``live`` (the shape of ``packed.vals``, default ``packed.vals != 0``)
    marks the slots that count as nonzero. A plan over values given at call
    time passes its structure
    (:func:`~sextans_tpu_torch.ops.autodiff.structure_mask`): every block that
    holds an entry is then walked, whatever its value now.
    """
    cfg = packed.config
    ng, G, bk = packed.n_groups, cfg.group_blocks, cfg.block_k
    per_tile = cfg.tile_m // MSLAB
    check_int32(ng * G, "slab_visits")
    tiles = check_owner_tiles(packed.group_mtile[:ng], packed.n_mtiles, "group_mtile")
    qm = np.asarray(packed.qm, dtype=np.int64)
    if qm.size and (qm.min() < 0 or qm.max() >= per_tile):
        raise ValueError(f"qm holds a slab outside [0, {per_tile})")
    slab = (tiles[:, None] * per_tile + qm).reshape(-1)
    check_int32(packed.k_padded, "slab_visits")
    rows = (np.asarray(packed.group_kwin, dtype=np.int64)[:, None] * cfg.window_k
            + packed.bcol).reshape(-1)
    live = packed.vals != 0 if live is None else live
    keep = live.reshape(ng * G, bk * MSLAB).any(axis=1)
    zero = np.flatnonzero(~keep)
    if zero.size:
        key = slab[zero] * packed.k_padded + rows[zero]
        _, first = np.unique(key, return_index=True)
        keep[zero[first]] = True
    kept = np.flatnonzero(keep)
    order = np.concatenate([kept[np.argsort(slab[kept], kind="stable")],
                            np.flatnonzero(~keep)])
    return (csr_ptr(slab[kept], packed.n_mtiles * per_tile), order.astype(np.int32),
            rows[order].astype(np.int32))


SLAB_HOST = PackHost(
    check=lambda packed, live: check_pack_indices(packed, packed.qm, packed.config.tile_m // MSLAB),
    arrays=lambda p: ((p.vals, np.float32), (p.qm, np.int32), (p.bcol, np.int32),
                      (p.group_mtile, np.int32), (p.group_kwin, np.int32)),
    scan=slab_visits)


def slab_edges(ranges, m: int, k: int, block_k: int) -> torch.Tensor:
    """The edge slabs of K1 on the tensor cores where B holds ``k`` rows and
    C ``m``: each slab that holds a row at or past m, or one of whose listed
    blocks (``ranges``, :func:`slab_visits`) reads a row at or past k,
    ascending, as an int32 tensor on ``ranges``' device. Their CTAs run
    apart, with the checks that would cost every other CTA time
    (``csrc/spmm_slab.cu``: spmm_slab_tc_kernel_edge). The list holds for B
    and C of more rows too, the padded ones included. Made once for each
    ``(m, k, block_k)`` and memoised on ``ranges[0]`` (the copy of the scan
    to the host waits for the device)."""
    memo = ranges[0].__dict__.setdefault("_slab_edges", {})
    key = (m, k, block_k)
    if key not in memo:
        ptr = ranges[0].cpu().numpy().astype(np.int64)
        rows = ranges[2].cpu().numpy()[: ptr[-1]].astype(np.int64)
        n_slabs = ptr.size - 1
        slab = np.repeat(np.arange(n_slabs), np.diff(ptr))
        edge = np.arange(n_slabs) * MSLAB + MSLAB > m
        edge[slab[rows + block_k > k]] = True
        memo[key] = torch.as_tensor(np.flatnonzero(edge).astype(np.int32),
                                    device=ranges[0].device)
    return memo[key]


def slab_in_place(packed) -> bool:
    """Whether ``SpmmPlan.__call__`` gives K1 and K2 the caller's B at its K
    rows and C and the output at its M rows: always, since the kernels zero
    B's rows past K and write no row past M themselves."""
    return True


def slab_runner(packed, n: int, ranges, image=None):
    """K1 (backend ``mxu``), or K2 for N <= ``SKINNY_MAX_N``, bound as
    ``SpmmPlan`` runs it: with the pack's M and K, so that it takes B and C
    as they lie; K1 reads ``image`` (:func:`k1_image`)."""
    kw = dict(ranges=ranges, precise=int(packed.config.precise), m=packed.m, k=packed.k,
              **group_static(packed.config))
    if n > SKINNY_MAX_N:
        return functools.partial(spmm_slab_padded, image=image, **kw)
    return functools.partial(spmm_slab_skinny_padded, **kw)


def k1_image(cfg, n: int, device: torch.device):
    """The maker of K1's operand tiles (:func:`slab_image`) where K1 runs on
    the tensor cores (plain mode, N > ``SKINNY_MAX_N``, on a card), else None."""
    if n > SKINNY_MAX_N and not cfg.precise and device.type == "cuda":
        return functools.partial(slab_image, block_k=cfg.block_k)
    return None
