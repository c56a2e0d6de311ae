"""What the metric readers take from the program's own spans and counters
(``sextans_tpu_torch/utils/profiling.py``): spans from the traced
sub-window's host ranges (``Trace.spans``), counters from
``sextans_tpu_torch.counters()`` once the run is over. A program without
them gives nothing to read, and each reader then returns None.

A recorded span costs the host tens of microseconds, as much as a product's
own host work on a small matrix, so the span readers take that cost out:
:func:`span_cost` measures it under the traced run's profiler, in the same
process, once the window is over. Host operations (``cpu_op``) are left as
recorded, as in the benchmark's own ``plan.call``."""

from __future__ import annotations

import bisect
import functools
from typing import Callable, List, NamedTuple, Optional

PLAN_SPAN = "sx.plan.call"  # SpmmPlan.__call__
KERNEL_SPAN = "sx.kernel."  # each kernel wrapper, sx.kernel.<wrapper>
CALIBRATION_SPAN = "bench.span_cost"
CALIBRATION_SPANS = 1000


class SpanCost(NamedTuple):
    """Host seconds the profiler adds for one recorded span: ``whole`` as
    the enclosing range sees it, ``inside`` between the span's own ends
    (the rest, ``whole - inside``, falls in the enclosing range's own time)."""
    whole: float
    inside: float


def counter(name: str) -> Optional[float]:
    """The program's counter ``name``, or None where it has none."""
    import sextans_tpu_torch as sx

    read = getattr(sx, "counters", None)
    value = read().get(name) if read is not None else None
    return None if value is None else float(value)


@functools.lru_cache(maxsize=1)
def span_cost() -> SpanCost:
    """The profiler's cost of one empty span, through ``traced`` (the traced
    run's activities) on this process's device; the second of two passes,
    so that the first pays for the profiler's start."""
    import torch
    from torch.profiler import record_function

    from bench_torch.trace import traced

    def run():
        for _ in range(CALIBRATION_SPANS):
            with record_function(CALIBRATION_SPAN):
                pass
        return CALIBRATION_SPANS

    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    traced(run, device)
    tr = traced(run, device)
    inner = [s.t1 - s.t0 for s in tr.spans if s.name == CALIBRATION_SPAN]
    return SpanCost(tr.window_s / tr.units, sum(inner) / len(inner))


def _spans(record, keep: Callable[[str], bool]) -> List:
    tr = record.trace
    return [s for s in tr.spans if keep(s.name)] if tr and tr.units else []


def _is_kernel(name: str) -> bool:
    return name.startswith(KERNEL_SPAN)


def _inside(spans: List, outer: List) -> List:
    """The ``spans`` that lie within one of ``outer`` (not overlapping one
    another, as one thread's ranges of one name are)."""
    outer = sorted(outer, key=lambda s: s.t0)
    starts = [s.t0 for s in outer]
    out = []
    for s in spans:
        i = bisect.bisect_right(starts, s.t0) - 1
        if i >= 0 and s.t1 <= outer[i].t1 and s is not outer[i]:
            out.append(s)
    return out


def kernel_host_ms(record) -> Optional[float]:
    """Host milliseconds a unit inside the kernel wrappers' spans, less the
    profiler's cost there: each one's own, and the whole of any other span
    within."""
    spans = _spans(record, _is_kernel)
    if not spans:
        return None
    within = _inside(_spans(record, lambda name: not _is_kernel(name)), spans)
    cost = span_cost()
    spent = (sum(s.t1 - s.t0 for s in spans) - len(spans) * cost.inside
             - len(within) * cost.whole)
    return spent / record.trace.units * 1e3


def plan_self_ms(record) -> Optional[float]:
    """Host milliseconds a unit inside ``SpmmPlan.__call__``'s spans, less
    the parts that the kernel wrappers' spans inside them cover: the plan's
    own time (pads, checks, the output's slice). Less the profiler's cost
    there too: each plan span's own, the part of each kernel span's outside
    its ends, and the whole of any other span within."""
    plans = _spans(record, lambda name: name == PLAN_SPAN)
    if not plans:
        return None
    within = _inside(_spans(record, lambda name: name != PLAN_SPAN), plans)
    kernels = [s for s in within if _is_kernel(s.name)]
    covered = {id(s) for s in _inside(within, kernels)}
    others = [s for s in within if not _is_kernel(s.name) and id(s) not in covered]
    cost = span_cost()
    spent = (sum(s.t1 - s.t0 for s in plans) - sum(s.t1 - s.t0 for s in kernels)
             - len(plans) * cost.inside - len(kernels) * (cost.whole - cost.inside)
             - len(others) * cost.whole)
    return spent / record.trace.units * 1e3
