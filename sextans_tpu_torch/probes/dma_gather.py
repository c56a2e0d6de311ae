"""P1's twin: the random-row gather with every slot multiplied.

``gather_spmm(cols, vals, b, staging=...)`` computes ``out[i] = sum_r
vals[i, r] * B[cols[i, r]]``, the sum of ``benchmarks/scratch/
dma_gather_probe.py``'s ``gather_spmm``, with the product and the sum
rounded apart, slot by slot in order. On a CUDA tensor it launches
``dma_gather_launch`` (``csrc/gather_probe.cu``) in one of two staging
modes; on a CPU tensor it runs the plain version ``gather_spmm_ref``, which
the kernel equals to the bit.

- ``direct``: each output row's thread group reads its R rows of B straight
  from device memory (K5's thread map, 16-byte loads where N % 4 == 0 and
  the pointers are aligned).
- ``async``: each CTA owns ``block`` output rows (the TPU's block, 256 or
  1024) and stages the rows of B of each group of
  :func:`async_group_rows` rows into a two-stage shared-memory ring by
  ``cp.async``, the next group's copies in flight while the current one is
  summed, as the TPU kernel double-buffers its band DMAs. N must be a
  multiple of 4 and both stages must fit one CTA's shared memory.

The TPU's alignment rules (M % block, K % 8) do not carry over: any M, K, N
and R >= 1.

Sweep (one card, its own process)::

    python3 -m sextans_tpu_torch.probes.dma_gather

N in {512, 128, 16} and R in {2, 4, 8} at K = 400,000 and M = 262,144, as the
TPU probe; ``direct`` and ``async`` at 256 and 1024 rows per CTA, timed in
turns with ``embedding_bag`` beside the bound; each line also says whether
the kernel equals its plain version there.
"""

from __future__ import annotations

import numpy as np
import torch

from sextans_tpu_torch.ops.launch import SMEM_LIMIT, SharedMemoryError, stream_of
from sextans_tpu_torch.probes import (
    SWEEP_K,
    SWEEP_M,
    card_line,
    check_cols,
    check_operands,
    gather_bound,
    library_gather,
    need_card,
    sweep_line,
    sweep_operands,
    sweep_report,
)
from sextans_tpu_torch.runtime.build import build_kernels, check_launch
from sextans_tpu_torch.utils.timing import abba_ms

__all__ = ["STAGINGS", "probe_inputs", "gather_spmm", "gather_spmm_ref", "async_group_rows",
           "main"]

STAGINGS = ("direct", "async")
# Bytes of one stage of the async ring: two stages leave room for three
# CTAs on an SM.
ASYNC_STAGE_BYTES = 32 << 10


def probe_inputs(seed: int = 0, *, k: int = 4096, n: int = 256, r: int = 4, m: int = 512):
    """The TPU probe's correctness inputs, drawn in its order from one numpy
    generator (``dma_gather_probe.py:133-139``): ``b`` (k, n) f32 standard
    normal, ``cols`` (m, r) i32 uniform in [0, k), ``vals`` (m, r) f32
    standard normal. The defaults are the probe's sizes."""
    rng = np.random.default_rng(seed)
    b = rng.standard_normal((k, n)).astype(np.float32)
    cols = rng.integers(0, k, (m, r)).astype(np.int32)
    vals = rng.standard_normal((m, r)).astype(np.float32)
    return b, cols, vals


def async_group_rows(r_slots: int, n: int, block: int) -> int:
    """Output rows per group of the async mode: as many as fit one stage of
    ``ASYNC_STAGE_BYTES`` (at least 1, at most ``block``). Raises
    :class:`SharedMemoryError` when two stages of one row's R rows of B do
    not fit one CTA."""
    row_bytes = 4 * r_slots * n
    if 2 * row_bytes > SMEM_LIMIT:
        raise SharedMemoryError(
            f"the async staging of R={r_slots} rows of N={n} floats takes {2 * row_bytes} "
            f"bytes for two stages of one output row, over {SMEM_LIMIT} bytes of shared memory"
        )
    return max(1, min(block, ASYNC_STAGE_BYTES // row_bytes))


def gather_spmm_ref(cols: torch.Tensor, vals: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version: ``acc = acc + vals[:, r] * B[cols[:, r]]`` for r in
    order from zero, each product and sum rounded once to f32."""
    cl = cols.long()
    acc = torch.zeros((cols.shape[0], b.shape[1]), dtype=torch.float32, device=b.device)
    for r in range(cols.shape[1]):
        acc = acc + vals[:, r, None] * b[cl[:, r]]
    return acc


def gather_spmm(cols: torch.Tensor, vals: torch.Tensor, b: torch.Tensor, *,
                staging: str = "direct", block: int = 256, checked: bool = True) -> torch.Tensor:
    """``out[i] = sum_r vals[i, r] * b[cols[i, r]]``, (M, N) f32, by the
    kernel in ``staging`` mode on a CUDA tensor, by the plain version on a
    CPU tensor. ``block``: output rows per CTA of the async mode.

    Raises ``ValueError`` for a wrong dtype, shape or device, for
    ``async`` with N not a multiple of 4 (or, on the card, an unaligned
    pointer), and for a column outside [0, K). ``checked=False`` skips that
    last scan, one read back from the device, for a caller that made the
    columns itself (the sweeps and the timings)."""
    if staging not in STAGINGS:
        raise ValueError(f"staging must be one of {STAGINGS}, got {staging!r}")
    if int(block) < 1:
        raise ValueError(f"block must be >= 1, got {block}")
    m, r, k, n = check_operands(cols, vals, b)
    if staging == "async":
        if n % 4:
            raise ValueError(f"async staging copies 16-byte pieces: N={n} must be a multiple of 4")
        group = async_group_rows(r, n, int(block))
    if checked:
        check_cols(cols, k)
    if cols.device.type == "cpu":
        return gather_spmm_ref(cols, vals, b)
    if cols.device.type != "cuda":
        raise ValueError(f"dma_gather runs on cpu or cuda, not {cols.device}")
    out = torch.empty((m, n), dtype=torch.float32, device=cols.device)
    aligned = n % 4 == 0 and b.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    if staging == "async" and not aligned:
        raise ValueError("async staging copies 16-byte pieces: b must be 16-byte aligned")
    lib = build_kernels()
    with torch.cuda.device(cols.device):
        err = lib.dma_gather_launch(
            cols.data_ptr(), vals.data_ptr(), b.data_ptr(), out.data_ptr(), m, r, n,
            STAGINGS.index(staging), 4 if aligned else 1, int(block),
            group if staging == "async" else 0, stream_of(cols.device))
    check_launch(lib, "dma_gather", err)
    gather_spmm.launches += 1
    return out


gather_spmm.launches = 0

# The sweep's modes: (label, staging, block).
SWEEP_MODES = (("direct", "direct", 256), ("async block=256", "async", 256),
               ("async block=1024", "async", 1024))


def main() -> int:
    """The sweep (module docstring); exits 1 if a kernel differs from its
    plain version, 2 without a card."""
    if not need_card("dma_gather"):
        return 2
    card = card_line()
    print(f"dma_gather sweep on {card}; K={SWEEP_K} M={SWEEP_M}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    lines = []
    for n in (512, 128, 16):
        b = torch.randn((SWEEP_K, n), generator=gen, device="cuda")
        for r in (2, 4, 8):
            cols, vals = sweep_operands(gen, SWEEP_K, SWEEP_M, r)
            bound = gather_bound(cols, n)
            want = gather_spmm_ref(cols, vals, b)
            runs = {label: (lambda s=staging, bl=block: gather_spmm(
                cols, vals, b, staging=s, block=bl, checked=False))
                for label, staging, block in SWEEP_MODES}
            equal = {label: torch.equal(run(), want) for label, run in runs.items()}
            del want
            ms = abba_ms({**runs, "library": lambda: library_gather(cols, vals, b)},
                          iters=5)
            for label in runs:
                lines.append(sweep_line(f"N={n:4d} R={r} {label:16s}", SWEEP_M, r, n,
                                        ms[label], bound, ms["library"], equal[label]))
        del b
    return sweep_report("dma_gather", card, lines)


if __name__ == "__main__":
    raise SystemExit(main())
