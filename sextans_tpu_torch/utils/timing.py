"""Kernel timing: the reference's rp_time protocol on a CUDA stream.

The reference repeats the kernel in-device ``rp_time`` times and divides the
wall time (src/sextans-host.cpp:223,237-252). Here ``SpmmPlan.repeat`` runs
the kernel ``times`` times on the current stream, feeding C back, and CUDA
events bracket the run. The time per call is the differential
``(wall(2T) - wall(T)) / T``, which cancels the fixed costs of one run
(padding, the first launch's latency), as ``sextans_tpu.utils.timing`` does.
A plan on the CPU is timed with the host clock instead, and its numbers are
CPU times.

A kernel beside its plain version and a library call is timed by
:func:`abba_ms` (``chip_smoke.py`` and the probes' sweeps), and its least
time is bounded with the card's peaks below.
"""

from __future__ import annotations

import statistics
import time
from typing import Callable, Dict

import torch

__all__ = ["time_repeat", "PEAK_F32_FLOPS", "PEAK_HBM_BYTES", "ROUNDS", "event_ms", "abba_ms",
           "timed_once"]

PEAK_F32_FLOPS = 67e12  # one H100 SXM, f32 outside the tensor cores
PEAK_HBM_BYTES = 3.35e12
ROUNDS = 3


def event_ms(fn: Callable, iters: int, warm: bool = True) -> float:
    """Mean device milliseconds of ``fn()`` over ``iters`` launches, after a
    warm-up launch if ``warm``, bracketed by CUDA events."""
    if warm:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def abba_ms(fns: Dict[str, Callable], iters: int, rounds: int = ROUNDS) -> Dict[str, float]:
    """Median of ``event_ms`` for each of ``fns``, sampled in turns: their
    order, then the reverse (plain, kernel, library, library, kernel, plain
    for those three), ``rounds`` times, over ``iters`` launches a sample.
    "plain" (called once by the caller just before) takes one launch a
    sample and no warm-up."""
    samples = {name: [] for name in fns}
    order = list(fns)
    for _ in range(rounds):
        for name in order + order[::-1]:
            if name != "plain":
                samples[name].append(event_ms(fns[name], iters))
            else:
                samples[name].append(event_ms(fns[name], 1, warm=False))
    return {name: statistics.median(s) for name, s in samples.items()}


def timed_once(fn: Callable):
    """``fn()`` and its device milliseconds, one call bracketed by CUDA
    events: how a slow plain version is timed, on the call that is compared
    with its kernel."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def _wall(plan, b, alpha, beta, c0, times: int) -> float:
    """Seconds for one ``plan.repeat(..., times)``, from its enqueue to its
    completion."""
    if plan.device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        plan.repeat(b, alpha, beta, c0, times=times)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    plan.repeat(b, alpha, beta, c0, times=times)
    return time.perf_counter() - t0


def time_repeat(plan, b, alpha, beta, c0, times: int = 10, detail: bool = False):
    """Seconds per kernel call of ``plan``; with ``detail=True`` returns
    ``(seconds, info)``, where ``info`` records the protocol and raw walls.

    Each wall is the shorter of two samples. When the two walls agree within
    noise, the differential is meaningless and the amortized ``wall(2T) / 2T``
    is reported instead (``method: "amortized"``), which can only
    overestimate.
    """
    times = max(times, 1)
    _wall(plan, b, alpha, beta, c0, times)  # warm-up: build, first launches
    w1 = min(_wall(plan, b, alpha, beta, c0, times) for _ in range(2))
    w2 = min(_wall(plan, b, alpha, beta, c0, 2 * times) for _ in range(2))
    dt = (w2 - w1) / times
    avg2 = w2 / (2 * times)
    method = "differential"
    if dt < 0.25 * avg2:
        dt, method = avg2, "amortized"
    if detail:
        return dt, {"method": method, "wall_T_s": w1, "wall_2T_s": w2,
                    "times": times, "device": str(plan.device)}
    return dt
