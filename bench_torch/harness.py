"""One run of one cell: set-up, the measured window, the traced sub-window,
the output check and the result.

Everything a cell needs is found by name (see ``bench_torch/__init__.py``);
adding a configuration, a traffic mix, a cell or a metric adds files and
entries and edits nothing here.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import importlib.util
import json
import math
import random
import time
import traceback
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Optional

import torch

from bench_torch import inputs, reference
from bench_torch.pattern import Pattern, make_pattern
from bench_torch.trace import Trace, traced

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    """A cell of ``BENCHMARK.json`` with everything it names, loaded."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


def resolve(bench: dict, name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``bench`` (``BENCHMARK.json``): its
    configuration file, ``traffic/<mix>.json``, ``limits/<cell>.json``, and
    the metrics it reports (those listing it, or listing no cells)."""
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    mine = lambda ms: [m for m in ms if name in m.get("workloads", [name])]
    return Cell(name, int(cell["chips"]), load_json(root / conf["file"]),
                load_json(BENCH_DIR / "traffic" / f"{cell['traffic']}.json"),
                load_json(BENCH_DIR / "limits" / f"{name}.json"),
                mine(bench["end_to_end"]), mine(bench["per_layer"]))


def load_reader(metric: str):
    """``metrics/<metric>.py`` (names may hold dots, so it is loaded by
    path), whose ``read(record)`` gives the metric or None."""
    path = BENCH_DIR / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"bench_torch.metrics.{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_loop(name: str):
    """``loops/<name>.py``, whose ``setup(ctx)`` builds the loop."""
    return importlib.import_module(f"bench_torch.loops.{name}")


@dataclass
class Context:
    """What a loop is given: the configuration and traffic, the run's seed
    and device, A's pattern with the seed's values (on the host, and the
    values on the device), whether to record spans, the hooks of a
    planted fault or control (none in a benchmark run), the ends of set-up's
    phases (``mark``) and the seconds of reference work in set-up
    (``apart``)."""

    config: dict
    traffic: dict
    seed: int
    device: torch.device
    pattern: Pattern
    vals: torch.Tensor
    spans: bool = False
    hooks: dict = field(default_factory=dict)
    phases: dict = field(default_factory=dict)
    apart_s: float = 0.0

    @property
    def alpha(self) -> float:
        return float(self.config["alpha"])

    @property
    def beta(self) -> float:
        return float(self.config["beta"])

    @property
    def n(self) -> int:
        return int(self.config["n"])

    def coo(self) -> reference.Coo:
        """A's pattern for the reference, on the device."""
        return reference.Coo.of(self.pattern, self.device)

    def hook(self, call: str, fn):
        """``fn``, or what a planted fault or control puts in its place."""
        return self.hooks[call](fn) if call in self.hooks else fn

    def span(self, name: str):
        """A host span named ``name`` in a traced run, else nothing."""
        return torch.profiler.record_function(name) if self.spans else contextlib.nullcontext()

    def normal(self, stream: str, shape) -> torch.Tensor:
        return inputs.normal(self.seed, stream, shape, self.device)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def mark(self, phase: str) -> None:
        """Note the host clock at the end of a set-up phase, once the
        device has finished it (``phases``, printed beside the result)."""
        self.sync()
        self.phases[phase] = time.perf_counter()

    @contextlib.contextmanager
    def apart(self):
        """Set-up work of the benchmark's own reference (a training target):
        its seconds are left out of ``setup_s``, as the check's are."""
        self.sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.sync()
            self.apart_s += time.perf_counter() - t0


def make_context(cell: Cell, seed: int, device: torch.device, spans: bool,
                 plant: Optional[Callable[[Context], dict]] = None) -> Context:
    """The loop's context: the configured pattern with values drawn from
    ``seed`` (the pattern is fixed, as a published matrix's is)."""
    pattern = make_pattern(cell.config["matrix"])
    vals = inputs.nonzero_normal(seed, "a_vals", (pattern.nnz,), device)
    ctx = Context(cell.config, cell.traffic, seed, device,
                  pattern._replace(vals=vals.cpu().numpy()), vals, spans)
    if plant is not None:
        ctx.hooks = plant(ctx)
    return ctx


@dataclass
class Record:
    """What the metric readers read: set-up, the window, the shape of the
    product and, in a traced run, the traced sub-window."""

    setup_s: float
    window_s: float
    units: int
    shape: dict
    trace: Optional[Trace] = None


class Caller:
    """Runs a loop's units with one caller in a closed loop (each unit
    starts when the last ends), synchronising every ``sync_ms`` and keeping
    a sample of ``sample`` answers drawn from the seed (a reservoir: every
    answer alike likely)."""

    def __init__(self, loop, traffic: dict, seed: int):
        self.loop = loop
        self.sync_s = float(traffic["sync_ms"]) / 1e3
        self.k = int(traffic["sample"])
        self.rng = random.Random(inputs.stream_seed(seed, "sample"))
        self.attempted = 0
        self.failed = 0
        self.error = ""
        self.samples: list = []
        self.last_sync = 0.0

    def start(self) -> float:
        """Open the window; returns its start on the host clock."""
        self.last_sync = time.perf_counter()
        return self.last_sync

    def until(self, deadline: float) -> int:
        """Units started before ``deadline`` on the host clock; returns how
        many."""
        start = self.attempted
        while time.perf_counter() < deadline:
            i = self.attempted
            self.attempted += 1
            try:
                out = self.loop.step(i)
            except Exception:  # a failed unit counts, and the loop goes on
                self.failed += 1
                self.error = self.error or traceback.format_exc()
                out = None
            if out is not None:
                self.offer(i, out)
            if time.perf_counter() - self.last_sync >= self.sync_s:
                self.loop.sync()
                self.last_sync = time.perf_counter()
        return self.attempted - start

    def offer(self, i: int, out) -> None:
        if len(self.samples) < self.k:
            self.samples.append((i, out))
        else:
            j = self.rng.randrange(i + 1)
            if j < self.k:
                self.samples[j] = (i, out)


def phase_seconds(ends: dict, t_start: float) -> dict:
    """Each phase's seconds, from the host-clock ends of phases in order."""
    out, last = {}, t_start
    for name, t in ends.items():
        out[name], last = t - last, t
    return out


def passes(value: Optional[float], limit: float) -> bool:
    """A number passes at or under its limit; one that could not be read
    (None, from NaN) fails."""
    return value is not None and value <= limit


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device, t_start: float,
             plant: Optional[Callable[[Context], dict]] = None, info: Callable = print,
             probe: Optional[Callable[[], str]] = None):
    """Set up, measure for ``seconds`` (with a traced sub-window in its
    middle if ``trace``), free the program, check its answers against the
    plain reference and return the result line's object. ``t_start`` is the
    process's start on the host clock. Off a card (``device`` "cpu": the
    tests) the result holds no metric. Returns the result and notes: what
    ``probe()`` (the card's clocks) read just before and after the window."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    t_cell = time.perf_counter()
    if on_card:  # the card's context, made here so that its start is a phase of its own
        torch.zeros(1, device=device)
        torch.cuda.synchronize(device)
    t_card = time.perf_counter()
    ctx = make_context(cell, seed, device, trace, plant)
    ctx.mark("matrix")
    loop = load_loop(cell.traffic["loop"]).setup(ctx)
    ctx.mark("warm_up")
    setup_s = time.perf_counter() - t_start - ctx.apart_s
    info("set-up done", setup_s)

    # where set-up's seconds went: the imports before this call, the card's
    # start, then each phase that the context and the loop mark
    notes = {"setup_s": setup_s, "reference_apart_s": ctx.apart_s,
             "setup_phases_s": phase_seconds({"imports": t_cell, "card": t_card,
                                              **ctx.phases}, t_start)}
    if probe is not None:
        notes["card_before_window"] = probe()
    caller = Caller(loop, cell.traffic, seed)
    tr = None
    t0 = caller.start()
    if trace:
        caller.until(t0 + seconds / 2)
        loop.sync()
        span = float(cell.traffic["trace_seconds"])
        tr = traced(lambda: caller.until(time.perf_counter() + span), device)
    caller.until(t0 + seconds)
    loop.sync()
    window_s = time.perf_counter() - t0
    if probe is not None:
        notes["card_after_window"] = probe()
    info("window done", window_s)
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0

    samples = caller.samples
    caller.samples = []
    loop.release()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    compared = {}
    for name, value in loop.check(samples):
        compared[name] = {"value": None if math.isnan(value) else value,
                          "limit": float(cell.limits[name])}
    completed = caller.attempted - caller.failed
    correct = (caller.failed == 0 and completed > 0
               and all(passes(c["value"], c["limit"]) for c in compared.values()))

    record = Record(setup_s, window_s, completed,
                    {"m": ctx.pattern.shape[0], "k": ctx.pattern.shape[1], "n": ctx.n,
                     "nnz": ctx.pattern.nnz}, tr)
    metrics = {}
    if on_card:
        for m in cell.per_layer if trace else cell.end_to_end:
            value = load_reader(m["name"]).read(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else device.type,
           "kind": torch.cuda.get_device_name(device) if on_card else device.type,
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": caller.attempted, "failed": caller.failed,
           "metrics": metrics, "device": dev}
    if tr is not None:
        dev["busy_s"] = tr.busy_s()
        dev["window_s"] = tr.window_s
        out["breakdown"] = tr.breakdown()
    if caller.error:
        info("first failed unit", caller.error)
    out["compared"] = compared
    return out, notes
