"""The traced sub-window: ``torch.profiler`` over a few steady units, read
back from its Chrome trace into device intervals and host spans.

The arithmetic of ``chip_smoke.py:profile`` (device time by kernel name,
the rest as other device work), except that the device's busy time is the
union of its operations' intervals, not their sum, so that work overlapping
on two streams counts once.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict
from typing import Callable, List, NamedTuple, Optional, Tuple

import torch

WINDOW_SPAN = "bench.trace_window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
BREAKDOWN_TOP = 10
NAME_CHARS = 120


class Op(NamedTuple):
    name: str
    cat: str
    t0: float  # seconds, the trace's own clock
    t1: float


def short(name: str) -> str:
    """A kernel's name without its return type and arguments, cut to
    NAME_CHARS characters."""
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    return name.split("(")[0][:NAME_CHARS]


class Trace:
    """Device operations and host spans inside the traced window, with the
    number of units the window ran."""

    def __init__(self, device: List[Op], spans: List[Op], ops: List[Op],
                 t0: float, t1: float, units: int):
        self.device = device
        self.spans = spans
        self.ops = ops
        self.t0, self.t1 = t0, t1
        self.units = units

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def device_s(self, keep: Callable[[Op], bool]) -> float:
        """Seconds of the device operations ``keep`` accepts (summed)."""
        return sum(op.t1 - op.t0 for op in self.device if keep(op))

    def busy(self) -> List[Tuple[float, float]]:
        """The union of the device operations' intervals, in order."""
        merged: List[List[float]] = []
        for op in sorted(self.device, key=lambda o: o.t0):
            if merged and op.t0 <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], op.t1)
            else:
                merged.append([op.t0, op.t1])
        return [(a, b) for a, b in merged]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy())

    def idle_pct(self) -> Optional[float]:
        """One less the union of the device's operations' intervals over
        the window's host-clock length, in percent; None for a window in
        which the device did nothing that the trace saw."""
        if not self.device or self.window_s <= 0:
            return None
        return 100.0 * (1.0 - self.busy_s() / self.window_s)

    def idle_gaps(self) -> List[Tuple[float, float]]:
        gaps, at = [], self.t0
        for a, b in self.busy():
            if a > at:
                gaps.append((at, a))
            at = max(at, b)
        if self.t1 > at:
            gaps.append((at, self.t1))
        return gaps

    def breakdown(self) -> dict:
        """The device operations that took most time, and the idle time by
        what the host was doing when each gap began (the innermost span of
        the benchmark's, then the innermost host operation)."""
        by_op = defaultdict(float)
        for op in self.device:
            by_op[short(op.name)] += op.t1 - op.t0
        gaps = self.idle_gaps()
        starts = [a for a, _ in gaps]
        span_at = innermost(self.spans, starts)
        op_at = innermost(self.ops, starts)
        by_host = defaultdict(float)
        for (a, b), span, op in zip(gaps, span_at, op_at):
            by_host[f"{span or '(no span)'} / {op or '(no op)'}"] += b - a
        top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                         ][:BREAKDOWN_TOP]
        return {"device_ops": top(by_op), "idle_gaps": top(by_host)}


def innermost(intervals: List[Op], points: List[float]) -> List[Optional[str]]:
    """For each of ``points`` (ascending), the name of the innermost of
    ``intervals`` (properly nested, as the ranges of one host thread are)
    that holds it, or None."""
    order = sorted(intervals, key=lambda o: (o.t0, -o.t1))
    starts = [o.t0 for o in order]
    out, stack, i = [], [], 0
    for p in points:
        j = bisect.bisect_right(starts, p)
        for o in order[i:j]:
            while stack and stack[-1].t1 <= o.t0:
                stack.pop()
            stack.append(o)
        i = max(i, j)
        while stack and stack[-1].t1 < p:
            stack.pop()
        out.append(stack[-1].name if stack else None)
    return out


def read_chrome(events: list, units: int) -> Trace:
    """A :class:`Trace` of a Chrome trace's events: the window is the
    ``WINDOW_SPAN`` range; device operations are clipped to it; spans and
    host operations are those of the window's own thread."""
    xs = [e for e in events if e.get("ph") == "X" and "ts" in e]
    win = next((e for e in xs if e.get("name") == WINDOW_SPAN), None)
    if win is None:
        raise RuntimeError(f"the trace holds no {WINDOW_SPAN!r} range")
    t0 = float(win["ts"]) * 1e-6
    t1 = t0 + float(win.get("dur", 0.0)) * 1e-6
    device, spans, ops = [], [], []
    for e in xs:
        cat = str(e.get("cat", "")).lower()
        a = float(e["ts"]) * 1e-6
        b = a + float(e.get("dur", 0.0)) * 1e-6
        if cat in DEVICE_CATS:
            a, b = max(a, t0), min(b, t1)
            if b > a:
                device.append(Op(str(e.get("name", "")), cat, a, b))
        elif e.get("tid") == win.get("tid") and e.get("pid") == win.get("pid") and e is not win:
            if cat == "user_annotation":
                spans.append(Op(str(e["name"]), cat, a, b))
            elif cat == "cpu_op":
                ops.append(Op(str(e["name"]), cat, a, b))
    return Trace(device, spans, ops, t0, t1, units)


def traced(run: Callable[[], int], device: torch.device) -> Trace:
    """Run ``run()`` (which returns the units it ran) under the profiler,
    from an idle device to a synchronise inside the window's range, and read
    the trace back."""
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    with profile(activities=activities) as prof:
        with record_function(WINDOW_SPAN):
            units = run()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return read_chrome(events, units)
