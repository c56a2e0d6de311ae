"""P2's twin: the ELL gather's issue path over value-0 slots.

``ell_issue(vals, cols, b, variant=...)`` computes ``out[i] = sum_r
(vals[i, r] != 0 ? vals[i, r] * B[cols[i, r]] : 0)``, the sum of
``benchmarks/scratch/ell_issue_probe.py``'s ``run_variant``: a slot whose
value is 0 adds exactly 0, whatever its row of B holds (a NaN in it
included), and its column may be anything. The product and the sum are
rounded apart, slot by slot in order. On a CUDA tensor it launches
``ell_issue_launch`` (``csrc/gather_probe.cu``); on a CPU tensor it runs the
plain version ``ell_issue_ref``, which both variants equal to the bit.

- ``skip``: a branch over each value-0 slot, which issues no load (the TPU's
  variant A, and K5 today).
- ``select``: a value-0 slot loads row 0 unconditionally and its product is
  selected out, never multiplied by 0 (the TPU's variants B, C and D, whose
  pads fetch chunk 0; their semaphore granularity has no counterpart on a
  direct-load path).

The TPU's rules (M % block, n_pad in {128, ..., 1024}) do not carry over:
any M, K, N and R >= 1.

Sweep (one card, its own process)::

    python3 -m sextans_tpu_torch.probes.ell_issue

N in {512, 128} and R in {4, 8} at K = 400,000 and M = 262,144, as the TPU
probe; ``skip`` and ``select`` at value-0 shares 0 (the probe's sweep; both
variants then do the same work) and 0.3 (its correctness share), timed in
turns with ``embedding_bag`` beside the bound of the live slots.
"""

from __future__ import annotations

import numpy as np
import torch

from sextans_tpu_torch.ops.launch import stream_of
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

__all__ = ["VARIANTS", "probe_inputs", "ell_issue", "ell_issue_ref", "main"]

VARIANTS = ("skip", "select")


def probe_inputs(seed: int = 0, *, k: int = 4096, n: int = 512, r: int = 4, m: int = 2048,
                 zero_share: float = 0.3):
    """The TPU probe's correctness inputs, drawn in its order from one numpy
    generator (``ell_issue_probe.py:150-156``): ``b`` (k, n) f32 standard
    normal, ``cols`` (m, r) i32 uniform in [0, k), ``vals`` (m, r) f32
    standard normal, then the mask that sets a ``zero_share`` of ``vals``
    to 0. The defaults are the probe's sizes."""
    rng = np.random.default_rng(seed)
    b = rng.standard_normal((k, n)).astype(np.float32)
    cols = rng.integers(0, k, (m, r)).astype(np.int32)
    vals = rng.standard_normal((m, r)).astype(np.float32)
    vals[rng.random((m, r)) < zero_share] = 0.0
    return b, cols, vals


def ell_issue_ref(vals: torch.Tensor, cols: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version: row 0 gathered for every value-0 slot, and
    ``acc = acc + where(vals[:, r] != 0, vals[:, r] * x, 0)`` for r in order
    from zero, each product and sum rounded once to f32."""
    live = vals != 0
    cl = torch.where(live, cols, 0).long()
    acc = torch.zeros((cols.shape[0], b.shape[1]), dtype=torch.float32, device=b.device)
    for r in range(cols.shape[1]):
        acc = acc + torch.where(live[:, r, None], vals[:, r, None] * b[cl[:, r]], 0.0)
    return acc


def ell_issue(vals: torch.Tensor, cols: torch.Tensor, b: torch.Tensor, *,
              variant: str = "skip", checked: bool = True) -> torch.Tensor:
    """``out[i] = sum_r (vals[i, r] != 0 ? vals[i, r] * b[cols[i, r]] : 0)``,
    (M, N) f32, by the kernel's ``variant`` on a CUDA tensor, by the plain
    version on a CPU tensor.

    Raises ``ValueError`` for a wrong dtype, shape or device, and for a
    nonzero slot whose column lies outside [0, K) (a value-0 slot's column
    may be anything). ``checked=False`` skips that scan, one read back from
    the device, for a caller that made the columns itself."""
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
    m, r, k, n = check_operands(cols, vals, b)
    if checked:
        check_cols(cols, k, live=vals != 0)
    if cols.device.type == "cpu":
        return ell_issue_ref(vals, cols, b)
    if cols.device.type != "cuda":
        raise ValueError(f"ell_issue runs on cpu or cuda, not {cols.device}")
    out = torch.empty((m, n), dtype=torch.float32, device=cols.device)
    vec = 4 if n % 4 == 0 and b.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0 else 1
    lib = build_kernels()
    with torch.cuda.device(cols.device):
        err = lib.ell_issue_launch(vals.data_ptr(), cols.data_ptr(), b.data_ptr(),
                                   out.data_ptr(), m, r, n, VARIANTS.index(variant), vec,
                                   stream_of(cols.device))
    check_launch(lib, "ell_issue", err)
    ell_issue.launches += 1
    return out


ell_issue.launches = 0


def main() -> int:
    """The sweep (module docstring); exits 1 if a kernel differs from its
    plain version, 2 without a card."""
    if not need_card("ell_issue"):
        return 2
    card = card_line()
    print(f"ell_issue sweep on {card}; K={SWEEP_K} M={SWEEP_M}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    lines = []
    for n in (512, 128):
        b = torch.randn((SWEEP_K, n), generator=gen, device="cuda")
        for r in (4, 8):
            for share in (0.0, 0.3):
                cols, vals = sweep_operands(gen, SWEEP_K, SWEEP_M, r, zero_share=share)
                bound = gather_bound(cols, n, live=vals != 0)
                want = ell_issue_ref(vals, cols, b)
                runs = {v: (lambda v=v: ell_issue(vals, cols, b, variant=v, checked=False))
                        for v in VARIANTS}
                equal = {v: torch.equal(run(), want) for v, run in runs.items()}
                del want
                ms = abba_ms({**runs, "library": lambda: library_gather(cols, vals, b)},
                              iters=5)
                for v in VARIANTS:
                    lines.append(sweep_line(f"N={n:4d} R={r} zeros={share:.1f} {v:6s}",
                                            SWEEP_M, r, n, ms[v], bound, ms["library"],
                                            equal[v]))
        del b
    return sweep_report("ell_issue", card, lines)


if __name__ == "__main__":
    raise SystemExit(main())
