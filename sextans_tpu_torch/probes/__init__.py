"""Twins of the TPU's random-row gather probes, and what their sweeps share.

``dma_gather`` is P1 (``benchmarks/scratch/dma_gather_probe.py``): the
gather ``out[i] = sum_r vals[i, r] * B[cols[i, r]]`` with every slot
multiplied, by two staging modes, ``direct`` and ``async``. ``ell_issue`` is
P2 (``benchmarks/scratch/ell_issue_probe.py``): the same sum where a slot
whose value is 0 adds exactly 0, by two issue paths, ``skip`` and
``select``. Both kernels are in ``csrc/gather_probe.cu``; on a CUDA tensor a
wrapper launches its kernel, on a CPU tensor it runs its plain PyTorch loop.

Each module's ``main()`` is a sweep at the TPU probes' sizes (K = 400,000,
M = 262,144), run on one card as its own process::

    python3 -m sextans_tpu_torch.probes.dma_gather
    python3 -m sextans_tpu_torch.probes.ell_issue

Shared here: the operand checks of both wrappers, the bound of one gather,
the library call beside it (``embedding_bag``, timed only), and the sweeps'
data and report lines. The sweeps time with ``abba_ms`` of
``sextans_tpu_torch.utils.timing``, as ``chip_smoke.py`` does.
"""

from __future__ import annotations

import json
import subprocess
import sys
from typing import Optional, Tuple

import torch

from sextans_tpu_torch.ops.launch import need
from sextans_tpu_torch.utils.timing import PEAK_F32_FLOPS, PEAK_HBM_BYTES

__all__ = [
    "SWEEP_K",
    "SWEEP_M",
    "check_operands",
    "check_cols",
    "gather_bound",
    "library_gather",
    "card_line",
    "sweep_operands",
    "sweep_line",
    "sweep_report",
    "need_card",
]

# The TPU probes' sweep shape (dma_gather_probe.py:148,153).
SWEEP_K = 400_000
SWEEP_M = 262_144


def check_operands(cols: torch.Tensor, vals: torch.Tensor, b: torch.Tensor):
    """Raise ``ValueError`` unless ``cols`` (M, R) i32, ``vals`` (M, R) f32
    and ``b`` (K, N) f32 are contiguous, on one device and non-empty;
    returns ``(m, r, k, n)``."""
    if cols.dim() != 2 or b.dim() != 2:
        raise ValueError("cols must be (M, R) and b (K, N)")
    (m, r), (k, n) = cols.shape, b.shape
    if min(m, r, k, n) < 1:
        raise ValueError(f"the gather needs M, R, K and N >= 1, got {(m, r, k, n)}")
    device = cols.device
    need(cols, "cols", torch.int32, (m, r), device)
    need(vals, "vals", torch.float32, (m, r), device)
    need(b, "b", torch.float32, (k, n), device)
    return m, r, k, n


def check_cols(cols: torch.Tensor, k: int, live: Optional[torch.Tensor] = None) -> None:
    """Raise ``ValueError`` if a column (of a ``live`` slot, where given)
    lies outside [0, k): the kernel would gather foreign memory. One read
    back from the device."""
    bad = (cols < 0) | (cols >= k)
    if live is not None:
        bad &= live
    if bool(bad.any()):
        which = "a nonzero slot's" if live is not None else "a slot's"
        raise ValueError(f"{which} column is outside [0, k={k})")


def gather_bound(cols: torch.Tensor, n: int,
                 live: Optional[torch.Tensor] = None) -> Tuple[float, str]:
    """Least milliseconds of one gather on the H100, and its limit: the
    larger of 2 flops per live slot and column over 67 TFLOP/s, and
    ``8 * M * R + 4 * N * U + 4 * M * N`` bytes (vals and cols, the U
    distinct rows of B that the live slots touch, the output) over 3.35
    TB/s. ``live`` marks the slots that count (all of them without it)."""
    touched = cols if live is None else cols[live]
    u = torch.unique(touched).numel()
    flop_ms = 2.0 * touched.numel() * n / PEAK_F32_FLOPS * 1e3
    byte_ms = (8.0 * cols.numel() + 4.0 * n * u + 4.0 * cols.shape[0] * n) / PEAK_HBM_BYTES * 1e3
    return max(flop_ms, byte_ms), "operations" if flop_ms > byte_ms else "bytes"


def library_gather(cols: torch.Tensor, vals: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One PyTorch call for the same sum, the yardstick of the timings:
    ``embedding_bag`` with per-slot weights. It multiplies every slot, so
    it equals P2's sum only where value-0 slots meet finite rows. Timed
    only; the wrappers never call it."""
    return torch.nn.functional.embedding_bag(cols, b, per_sample_weights=vals, mode="sum")


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def sweep_operands(gen: torch.Generator, k: int, m: int, r: int, zero_share: float = 0.0):
    """``(cols, vals)`` made on the card from ``gen``: columns uniform in
    [0, k), values standard normal, a ``zero_share`` of them set to 0."""
    cols = torch.randint(0, k, (m, r), generator=gen, device=gen.device, dtype=torch.int32)
    vals = torch.randn((m, r), generator=gen, device=gen.device)
    if zero_share:
        vals[torch.rand((m, r), generator=gen, device=gen.device) < zero_share] = 0.0
    return cols, vals


def sweep_line(label: str, m: int, r: int, n: int, ms: float, bound: Tuple[float, str],
               library_ms: float, equal: bool) -> dict:
    """Print one sweep line and return it as a record: rows gathered per
    second (the TPU probe's DMA rate), gathered GB/s (4 * N * M * R / t),
    GF-equivalent (2 * M * R * N / t), the bound and the library call."""
    rows_s = m * r / (ms * 1e-3)
    gb_s = 4.0 * n * m * r / (ms * 1e-3) / 1e9
    gf = 2.0 * m * r * n / (ms * 1e-3) / 1e9
    print(f"{label}: {ms:9.4f} ms {rows_s / 1e6:8.1f} M rows/s {gb_s:8.1f} GB/s gathered "
          f"{gf:7.1f} GF-equiv  bound {bound[0]:.4f} ms ({bound[1]})  embedding_bag "
          f"{library_ms:.4f} ms  kernel == plain {equal}", flush=True)
    return dict(label=label, m=m, r=r, n=n, ms=ms, m_rows_per_s=rows_s / 1e6,
                gathered_gb_per_s=gb_s, gf_equiv=gf, bound_ms=bound[0], bound_by=bound[1],
                library_ms=library_ms, equal_to_plain=equal)


def sweep_report(probe: str, card: str, lines: list) -> int:
    """Print the sweep's JSON line; 1 if a kernel differed from its plain
    version, else 0."""
    print(json.dumps({"probe": probe, "card": card, "device": torch.cuda.get_device_name(0),
                      "k": SWEEP_K, "m": SWEEP_M, "lines": lines}))
    return 0 if all(line["equal_to_plain"] for line in lines) else 1


def need_card(probe: str) -> bool:
    """False, with a note on stderr, where no CUDA device is present: the
    sweeps time the card and nothing else."""
    if torch.cuda.is_available():
        return True
    print(f"{probe}: torch.cuda.is_available() is False; the sweep times the card only",
          file=sys.stderr)
    return False
