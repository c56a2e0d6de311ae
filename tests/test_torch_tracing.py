"""The port's spans and counters (``sextans_tpu_torch/utils/profiling.py``)
on the CPU: no span object while no profiler records, the spans' nesting
under ``torch.profiler``, the counters' exact counts, the clocked spans'
device time on a fake event clock, and the benchmark's readers of them
(``bench_torch/program.py``) on a CPU traced window. One card test holds
the clock to the profiler's kernel time; it skips without a card.
"""

from __future__ import annotations

import torch_cpu  # noqa: F401  one torch thread per xdist worker

import collections
import time
import types

import pytest
import torch
from torch.profiler import profile

import sextans_tpu_torch as tx
from sextans_tpu_torch.ops import df32
from sextans_tpu_torch.ops.hybrid_hub import hybrid_hub
from sextans_tpu_torch.ops.spmm_block import spmm_block_padded
from sextans_tpu_torch.ops.spmm_dia import spmm_dia, spmm_dia_skinny
from sextans_tpu_torch.ops.spmm_edge import spmm_edge_padded
from sextans_tpu_torch.ops.spmm_ell import spmm_ell_gather_padded
from sextans_tpu_torch.ops.sddmm import sddmm_rows
from sextans_tpu_torch.ops.spmm_slab import spmm_slab_padded, spmm_slab_skinny_padded
from sextans_tpu_torch.probes import dma_gather, ell_issue
from sextans_tpu_torch.utils import profiling
from sextans_tpu_torch.utils.matrices import fem_like

N = 40  # over 32: the mxu backend runs K1 (spmm_slab_padded)
CFG = tx.SpmmConfig(tile_m=256, window_k=512, block_k=16, group_blocks=8)
WRAPPERS = (spmm_slab_padded, spmm_slab_skinny_padded, spmm_block_padded, spmm_edge_padded,
            spmm_ell_gather_padded, spmm_dia, spmm_dia_skinny, df32.eft_probe_pairs,
            df32.eft_probe_chain, dma_gather.gather_spmm, ell_issue.ell_issue, sddmm_rows,
            hybrid_hub)


@pytest.fixture(scope="module")
def coo():
    return fem_like(600, dofs=3, neighbors=5, seed=2)


@pytest.fixture(scope="module")
def plan(coo):
    return tx.SpmmPlan(tx.pack_mxu(coo, CFG), N, "mxu", device="cpu")


def operands(plan, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(plan.k, plan.n, generator=g), torch.randn(plan.m, plan.n, generator=g))


def spans(prof, prefix="sx."):
    """The profiler's ranges named ``prefix...``: name -> [(start, end)]."""
    out = {}
    for e in prof.events():
        if e.name.startswith(prefix):
            out.setdefault(e.name, []).append((e.time_range.start, e.time_range.end))
    return out


def inside(inner, outer) -> bool:
    return any(a <= s and t <= b for s, t in inner for a, b in outer)


@pytest.fixture
def made(monkeypatch):
    """Counts the ``record_function`` objects the port's spans build."""
    built = []
    real = profiling.record_function

    def counting(name):
        built.append(name)
        return real(name)

    monkeypatch.setattr(profiling, "record_function", counting)
    return built


def test_annotate_without_a_profiler_is_the_shared_no_op(made):
    assert not profiling.recording()
    first, second = profiling.annotate("sx.a"), profiling.annotate("sx.b")
    assert first is second
    with first:
        with second:  # the no-op nests
            pass
    assert made == []


class FakeEvent:
    """An event of the fake clock: the time it was recorded at (ms)."""

    def __init__(self, clock):
        self.at = clock.now
        self.waits = 0
        clock.events.append(self)

    def synchronize(self):
        self.waits += 1

    def elapsed_time(self, end):
        return end.at - self.at


@pytest.fixture
def clock(monkeypatch):
    """A fake card clock in place of the CUDA events (``profiling._mark``):
    an event records ``clock.now``, which the test moves; fresh counters
    and no pending span."""
    fake = types.SimpleNamespace(now=0.0, events=[])
    monkeypatch.setattr(profiling, "_mark", lambda device: FakeEvent(fake))
    monkeypatch.setattr(profiling, "_COUNTERS", {})
    monkeypatch.setattr(profiling, "_PENDING", collections.deque())
    return fake


CARD = torch.device("cuda", 0)  # named, never touched: the fake clock records


def test_clocked_annotate_without_a_profiler_is_the_shared_no_op(made, clock):
    assert not profiling.recording()
    first, second = profiling.annotate("sx.a", CARD), profiling.annotate("sx.b")
    assert first is second
    with first:
        with profiling.annotate("sx.c", torch.device("cpu")):
            clock.now += 1.0
    assert made == [] and clock.events == [] and not profiling._PENDING
    assert profiling.counters() == {}


def test_clocked_spans_are_inclusive_and_resolve_once(made, clock):
    with profile():
        with profiling.annotate("sx.outer", CARD):  # 0 .. 10
            clock.now = 2.0
            for _ in range(2):  # 2 .. 5 and 6 .. 9
                with profiling.annotate("sx.inner", CARD):
                    with profiling.annotate("sx.unclocked"):
                        clock.now += 3.0
                clock.now += 1.0
    assert made == ["sx.outer", "sx.inner", "sx.unclocked", "sx.inner", "sx.unclocked"]
    assert len(profiling._PENDING) == 3 and len(clock.events) == 6
    got = profiling.counters()
    assert got == {"device_ms.sx.outer": 10.0, "spans.sx.outer": 1,
                   "device_ms.sx.inner": 6.0, "spans.sx.inner": 2}
    assert not profiling._PENDING
    assert [e.waits for e in clock.events] == [0, 0, 1, 0, 1, 1]  # each exit event, once
    assert profiling.counters() == got


def test_span_on_a_cpu_device_records_nothing(made, clock):
    with profile() as prof:
        with profiling.annotate("sx.cpu", torch.device("cpu")):
            torch.ones(4) + 1
    assert made == ["sx.cpu"] and "sx.cpu" in spans(prof)
    assert clock.events == [] and profiling.counters() == {}


def test_annotate_under_a_profiler_makes_a_range(made):
    with profile() as prof:
        with profiling.annotate("sx.test.span"):
            torch.ones(4) + 1
    assert made == ["sx.test.span"]
    assert "sx.test.span" in spans(prof)


def test_plan_call_without_a_profiler_opens_no_span(plan, made):
    b, c = operands(plan)
    plan(b, 0.85, -2.06, c)
    plan(b, 0.5)
    assert made == []


def test_plan_call_spans_nest(plan):
    b, c = operands(plan)
    with profile() as prof:
        plan(b, 0.85, -2.06, c)
    got = spans(prof)
    assert len(got["sx.plan.call"]) == 1
    inner = got["sx.kernel.spmm_slab_padded"]
    assert len(inner) == 1 and inside(inner, got["sx.plan.call"])
    assert sorted(got) == ["sx.kernel.spmm_slab_padded", "sx.plan.call"]  # one a layer


def test_plan_call_without_c_has_no_pad_c_span(plan):
    b, _ = operands(plan)
    with profile() as prof:
        plan(b, 0.5)
    got = spans(prof)
    assert "sx.plan.pad_c" not in got
    assert inside(got["sx.kernel.spmm_slab_padded"], got["sx.plan.call"])


@pytest.mark.parametrize("with_c", [True, False])
def test_traced_plan_call_gives_the_same_bits(plan, with_c):
    b, c = operands(plan, seed=3)
    args = (b, 0.85, -2.06, c) if with_c else (b, 0.85)
    off = plan(*args)
    with profile():
        on = plan(*args)
    assert torch.equal(on, off)


def value_op_step(op, coo, seed=0):
    """One step of the value op: the output and the gradients of vals, B,
    C, alpha and beta."""
    g = torch.Generator().manual_seed(seed)
    vals = torch.as_tensor(coo.vals, dtype=torch.float32).requires_grad_()
    b = torch.randn(coo.shape[1], N, generator=g).requires_grad_()
    c = torch.randn(coo.shape[0], N, generator=g).requires_grad_()
    al, be = torch.tensor(0.85, requires_grad=True), torch.tensor(-2.06, requires_grad=True)
    out = op(vals, b, c, al, be)
    out.square().mean().backward()
    return [out.detach()] + [t.grad for t in (vals, b, c, al, be)]


def test_value_op_step_spans(coo, clock):
    op = tx.spmm_value_op(coo, N, config=CFG, fmt="mxu", device="cpu")
    with profile() as prof:
        value_op_step(op, coo)
    got = spans(prof)
    for name in ("sx.autodiff.forward", "sx.autodiff.backward", "sx.autodiff.ab",
                 "sx.autodiff.sddmm", "sx.autodiff.atg", "sx.autodiff.scatter",
                 "sx.kernel.spmm_slab_padded", "sx.kernel.sddmm_rows"):
        assert name in got, name
    fwd, bwd = got["sx.autodiff.forward"], got["sx.autodiff.backward"]
    assert len(fwd) == len(bwd) == 1
    assert inside(got["sx.autodiff.ab"], fwd)
    for name in ("sx.autodiff.sddmm", "sx.autodiff.atg"):
        assert inside(got[name], bwd) and not inside(got[name], fwd), name
    scatter = sorted(got["sx.autodiff.scatter"])
    assert len(scatter) == 2  # A's in the forward, A^T's in the backward
    assert inside(scatter[:1], got["sx.autodiff.ab"]) and inside(scatter[:1], fwd)
    assert inside(scatter[1:], got["sx.autodiff.atg"]) and inside(scatter[1:], bwd)
    assert len(got["sx.kernel.sddmm_rows"]) == 1
    assert inside(got["sx.kernel.sddmm_rows"], got["sx.autodiff.sddmm"])
    assert len(got["sx.kernel.spmm_slab_padded"]) == 2  # A and A^T
    assert clock.events == [] and not profiling._PENDING  # a CPU op clocks nothing


def test_traced_value_op_step_gives_the_same_bits(coo):
    op = tx.spmm_value_op(coo, N, config=CFG, fmt="mxu", device="cpu")
    off = value_op_step(op, coo, seed=5)
    with profile():
        on = value_op_step(op, coo, seed=5)
    assert len(on) == len(off) == 6
    for a, b in zip(on, off):
        assert torch.equal(a, b)


def test_plan_counters_are_exact(coo, plan):
    """The slab route takes B and C in place: five calls, five in place, no
    byte made; the block route (``pallas``) on the same matrix pads B and C,
    and counts each padded byte."""
    b, c = operands(plan)
    padded = tx.SpmmPlan(tx.pack(coo, CFG), N, "pallas", device="cpu")
    for pl, in_place in ((plan, 5), (padded, 0)):
        before = tx.counters()
        for _ in range(3):
            pl(b, 0.85, -2.06, c)
        for _ in range(2):
            pl(b, 0.5)
        after = tx.counters()
        kp, mp = pl.packed.k_padded, pl.packed.m_padded
        assert kp > pl.k and mp > pl.m
        made = 4 * N * (3 * (kp + mp) + 2 * kp) if not in_place else 0
        assert after["plan.calls"] - before.get("plan.calls", 0) == 5
        assert after.get("plan.in_place", 0) - before.get("plan.in_place", 0) == in_place
        assert after.get("plan.pad_bytes", 0) - before.get("plan.pad_bytes", 0) == made


def test_counters_is_a_copy():
    profiling.count("test.copy", 2)
    got = tx.counters()
    got["test.copy"] = -1
    assert tx.counters()["test.copy"] >= 2


def test_nested_timed_counts_once():
    name = "test.nested_s"
    before = tx.counters().get(name, 0.0)
    t0 = time.perf_counter()
    with profiling.timed(name):
        with profiling.timed(name):
            time.sleep(0.02)
        time.sleep(0.02)
    outer = time.perf_counter() - t0
    got = tx.counters()[name] - before
    assert 0.04 <= got <= outer


def test_pack_and_plan_add_set_up_seconds(coo):
    before = tx.counters()
    packed = tx.pack_mxu(coo, CFG)
    mid = tx.counters()
    tx.SpmmPlan(packed, N, "mxu", device="cpu")
    after = tx.counters()
    assert mid["pack_s"] > before.get("pack_s", 0.0)
    assert mid.get("upload_s", 0.0) == before.get("upload_s", 0.0)
    assert after["upload_s"] > mid.get("upload_s", 0.0)


@pytest.mark.parametrize("wrapper", WRAPPERS, ids=lambda f: f.__name__)
def test_kernel_wrapper_keeps_no_launch_attribute(wrapper):
    assert not hasattr(wrapper, "launches")
    assert profiling.launches(wrapper) == tx.counters().get(f"launch.{wrapper.__name__}", 0)


def test_cpu_product_counts_no_launch(plan):
    b, c = operands(plan)
    before = profiling.launches(spmm_slab_padded)
    plan(b, 0.85, -2.06, c)
    assert profiling.launches(spmm_slab_padded) == before


# ---- the benchmark's readers of the spans and counters ----

def traced_window(plan, calls=4):
    """A CPU traced window of ``calls`` products, each inside the
    benchmark's own ``plan.call`` span, as its repeat loop makes them."""
    from bench_torch import harness
    from bench_torch.trace import traced

    b, c = operands(plan)

    def run():
        for _ in range(calls):
            with torch.profiler.record_function("plan.call"):
                plan(b, 0.85, -2.06, c)
        return calls

    tr = traced(run, torch.device("cpu"))
    return harness.Record(0.0, tr.window_s, calls, {}, tr)


def test_span_readers_read_the_plan_and_its_kernel(plan):
    from bench_torch import harness

    record = traced_window(plan)
    plan_ms = harness.load_reader("plan_host_ms.l2").read(record)
    launch_ms = harness.load_reader("launch_host_ms.l2").read(record)
    outer = [s for s in record.trace.spans if s.name == "plan.call"]
    assert len(outer) == record.units
    outer_ms = sum(s.t1 - s.t0 for s in outer) / record.units * 1e3
    assert plan_ms > 0 and launch_ms > 0
    assert plan_ms + launch_ms <= outer_ms


def test_span_cost_is_measured_under_the_profiler():
    from bench_torch.program import span_cost

    cost = span_cost()
    assert 0.0 < cost.inside < cost.whole < 1e-3


def test_span_readers_take_out_the_span_cost(monkeypatch):
    from bench_torch import harness, program
    from bench_torch.trace import Op, Trace

    us = 1e-6
    spans = []
    for unit in range(2):  # two products, 100 us apart
        at = unit * 100 * us

        def span(name, a, b):
            spans.append(Op(name, "user_annotation", at + a * us, at + b * us))

        span("plan.call", 0, 100)  # the benchmark's own
        span("sx.plan.call", 10, 90)
        span("sx.other", 15, 20)  # another span in the plan's own time
        span("sx.kernel.spmm_slab_padded", 30, 70)
        span("sx.deep", 40, 50)  # another span in the kernel's
    tr = Trace([], spans, [], 0.0, 200 * us, 2)
    record = harness.Record(0.0, tr.window_s, 2, {}, tr)
    monkeypatch.setattr(program, "span_cost", lambda: program.SpanCost(4 * us, 1 * us))
    # plan: 80 - 40 us, less its own 1, the kernel's outer 3 and sx.other's 4
    assert harness.load_reader("plan_host_ms.l2").read(record) == pytest.approx(32e-3)
    # kernel: 40 us, less its own 1 and sx.deep's 4
    assert harness.load_reader("launch_host_ms.l2").read(record) == pytest.approx(35e-3)


def test_span_readers_find_nothing_without_the_programs_spans(plan):
    from bench_torch import harness
    from bench_torch.trace import traced

    tr = traced(lambda: 1, torch.device("cpu"))
    record = harness.Record(0.0, tr.window_s, 1, {}, tr)
    for metric in ("plan_host_ms.l2", "launch_host_ms.l2"):
        assert harness.load_reader(metric).read(record) is None


def test_counter_readers(coo, plan, monkeypatch):
    from bench_torch import harness

    monkeypatch.setattr(profiling, "_COUNTERS", {})
    b, c = operands(plan)
    record = harness.Record(0.0, 1.0, 2, {}, None)
    assert harness.load_reader("plan_copy_mb.repeat").read(record) is None
    plan(b, 0.85, -2.06, c)
    plan(b, 0.85, -2.06, c)
    assert harness.load_reader("plan_copy_mb.repeat").read(record) == 0.0  # in place
    padded = tx.SpmmPlan(tx.pack(coo, CFG), N, "pallas", device="cpu")
    monkeypatch.setattr(profiling, "_COUNTERS", {})
    padded(b, 0.85, -2.06, c)
    padded(b, 0.85, -2.06, c)
    kp, mp = padded.packed.k_padded, padded.packed.m_padded
    assert harness.load_reader("plan_copy_mb.repeat").read(record) == 4 * N * (kp + mp) / 1e6
    profiling.count("pack_s", 1.5)
    profiling.count("upload_s", 0.25)
    assert harness.load_reader("pack_s").read(record) == 1.5
    assert harness.load_reader("upload_s").read(record) == 0.25
    assert harness.load_reader("library_s").read(record) is None  # no library on the CPU


CLOCK_READERS = {  # metric -> the clocked spans it sums
    "slab_image_device_ms.train": ("sx.plan.slab_image",),
    "scatter_device_ms.train": ("sx.autodiff.scatter",),
    "value_op_device_ms.train": ("sx.autodiff.forward", "sx.autodiff.backward"),
}


@pytest.mark.parametrize("metric", sorted(CLOCK_READERS))
def test_clock_readers(metric, clock):
    from bench_torch import harness
    from bench_torch.trace import Trace

    reader = harness.load_reader(metric)
    steps = 4
    record = harness.Record(0.0, 1.0, steps, {}, Trace([], [], [], 0.0, 1.0, steps))
    assert reader.read(record) is None  # no clocked span: the CPU, or no clock
    with profile():
        for ms in (3.0, 5.0):
            for span in CLOCK_READERS[metric]:
                with profiling.annotate(span, CARD):
                    clock.now += ms
    want = 8.0 * len(CLOCK_READERS[metric]) / steps
    assert reader.read(record) == pytest.approx(want)
    assert reader.read(harness.Record(0.0, 1.0, steps, {}, None)) is None  # untraced


@pytest.mark.gpu
def test_sddmm_span_clock_matches_the_kernels_time():
    """On a card: the SDDMM span's clock (``device_ms.sx.autodiff.sddmm``)
    against ``torch.profiler``'s time of the SDDMM kernel in it, within 5 %.
    The card sleeps before each call, so that the span's entry event waits
    on the stream as in a training step, not on the host's launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch.profiler import ProfilerActivity

    card = torch.device("cuda", torch.cuda.current_device())
    a = fem_like(20000, dofs=3, neighbors=22, seed=2)
    op = tx.spmm_value_op(a, 512, config=CFG, fmt="mxu", device=card)
    g = torch.Generator(device=card).manual_seed(0)
    grad = torch.randn(a.shape[0], 512, device=card, generator=g)
    b = torch.randn(a.shape[1], 512, device=card, generator=g)
    op.sddmm(grad, b)
    torch.cuda.synchronize(card)
    calls, before = 5, tx.counters()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            torch.cuda._sleep(2_000_000)
            op.sddmm(grad, b)
        torch.cuda.synchronize(card)
    after = tx.counters()
    span = "sx.autodiff.sddmm"
    assert after[f"spans.{span}"] - before.get(f"spans.{span}", 0) == calls
    clocked = after[f"device_ms.{span}"] - before.get(f"device_ms.{span}", 0.0)
    kernel = sum(e.device_time_total for e in prof.key_averages()
                 if "sddmm_tile_kernel" in e.key) / 1e3
    assert kernel > 0.0
    assert abs(clocked - kernel) <= 0.05 * kernel, (clocked, kernel)
