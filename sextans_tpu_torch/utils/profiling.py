"""Profiling hooks: the port's spans and counters.

The PyTorch counterpart of ``sextans_tpu.utils.profiling``: ``trace``
records ``torch.profiler`` (host and, where there is a card, CUDA activity)
around any code and writes a Chrome trace (``chrome://tracing``, Perfetto).

The program names its own work on that timeline with ``annotate`` (a
``record_function`` range while a profiler records, else one shared no-op:
tracing is on exactly when someone profiles) and counts it with ``count``
into one process-wide dictionary that ``counters()`` returns. ``timed``
is for set-up-scale work: a span that also adds its host seconds to a
counter of the same name. A span given its CUDA device (``annotate(name,
device)``) is also clocked on the card while a profiler records: a timing
CUDA event on the current stream at its entry and one at its exit, which
``counters()`` resolves into ``device_ms.<span>`` (the events' elapsed
milliseconds, summed; a span nested in another counts in both) and
``spans.<span>`` (how many). A span's device time is the stream's time from
its entry to its exit, so it holds any time the card waited for the host
inside the span, not only the work the span queued. Names:

* spans: ``sx.plan.call`` (``SpmmPlan.__call__``: the pads, the kernel
  wrapper, the output's slice); ``sx.kernel.<wrapper>`` around each kernel
  wrapper K1-K7 and the SDDMM's, on either device; in a training step
  ``sx.autodiff.forward`` and ``sx.autodiff.backward`` (the value op's
  forward and backward, the backward on autograd's thread), inside them
  ``sx.autodiff.ab``, ``.atg``, ``.sddmm``, ``.scatter`` and
  ``sx.plan.slab_image``; ``sx.hybrid.call`` (a ``HybridSpmmPlan`` step)
  and, inside it, ``sx.hybrid.dense`` (its head columns and hub rows: the
  row-sparse pass ``hybrid_hub`` on the ``"pallas"`` route, else their
  matmuls, gather and adds). Clocked on a card: ``sx.autodiff.forward``,
  ``.backward``, ``.scatter``, ``.sddmm``, ``sx.plan.slab_image`` and
  ``sx.hybrid.dense``; not ``sx.plan.call``, ``sx.hybrid.call`` or
  ``sx.kernel.*``, whose host time the benchmark reads (an event's record
  would add to it) and whose kernels a trace times by name.
  A product opens two, one a layer: a recorded span costs the host about
  as much as a pad's own host work, so finer spans would mostly time
  themselves;
* counters: ``plan.calls``, ``plan.pad_bytes`` (bytes of the B and C the
  plan made: pads and the gathers of a reordered pack), ``plan.in_place``
  (the calls that handed the slab kernels, the edge kernel or the ELL
  gather kernel B, C and the output unpadded);
  ``launch.<wrapper>``, the kernel launches of each wrapper on a card
  (:func:`launches`), ``launch.spmm_edge_padded.precise1`` and
  ``.precise2``, those of K4 at each precise level, and
  ``launch.spmm_dia.entries``, those of K6 that walk its entry map;
  ``dia.walk_entries``, the entries of the K6 entry maps the hybrid plans
  take, once a plan; ``device_ms.<span>``
  and ``spans.<span>`` of the clocked spans; ``pack_s``, ``upload_s`` and
  ``library_s``, host seconds of the packers and ``split_structure``, of the upload to the
  device and of loading (or compiling) the kernel library; ``sddmm.entries`` and
  ``sddmm.b_rows``, the entries of the SDDMM's host plans and the B rows
  their tiles stage a call (their ratio is each staged row's reuse);
  ``ell.entries``, ``ell.slots``, ``ell.rows`` and ``ell.fold_rows``, an ELL
  pack's entries, slots (padded rows times R), padded rows and the virtual
  rows its plans fold, once a pack at upload; ``ell.tiles`` and
  ``ell.tile_rows``, K5's tiles and the logical rows they hold
  (``ops/spmm_ell.py:ell_tiles``); ``edge.entries`` and ``edge.slots``, an
  edge pack's entries and its chunks' slots, once a pack at upload;
  ``edge.runs`` and ``edge.rows``, the runs of K4's host scan and the padded
  rows that have one, once a pack and device (``ops/spmm_edge.py:row_runs``);
  ``hybrid.calls``, the steps of ``HybridSpmmPlan``; ``hybrid.diag_entries``
  and ``hybrid.diag_slots``, ``hybrid.dense_entries`` and
  ``hybrid.dense_slots``, the entries and slots of a hybrid split's
  diagonal and dense hub planes, and ``hybrid.residue_entries``, once a
  split at upload (``ops/hybrid.py``); ``hybrid.hub_entries`` and
  ``hybrid.hub_rows``, the entries and rows of the lists the row-sparse
  pass walks, once a plan that makes them (``launch.hybrid_hub`` counts
  that pass's launches on a card: one a plain step, one a part a precise
  step).
"""

from __future__ import annotations

import collections
import contextlib
import os
import tempfile
import time
from pathlib import Path
from typing import Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function

__all__ = ["trace", "annotate", "recording", "count", "counters", "launches", "timed"]

# whether a profiler records: a C call, the cheapest test there is
recording = torch.autograd._profiler_enabled

_OFF = contextlib.nullcontext()
_COUNTERS: dict = {}
_TIMED_DEPTH: dict = {}
# (span, entry event, exit event) of the clocked spans that counters() has
# not resolved yet; a deque, since autograd's thread appends to it too
_PENDING: collections.deque = collections.deque()


@contextlib.contextmanager
def trace(logdir=None):
    """Record a trace of the block and write it to
    ``<logdir>/trace_<pid>.json`` (``logdir`` defaults to
    ``$TMPDIR/sextans_tpu_torch_trace``); yields the ``torch.profiler``
    profile, whose ``key_averages()`` sum the device time by kernel. The
    trace holds the program's spans (see the module).

    >>> with trace("traces") as prof:
    ...     plan(b, alpha, beta, c); torch.cuda.synchronize()
    """
    logdir = Path(logdir or Path(tempfile.gettempdir()) / "sextans_tpu_torch_trace")
    logdir.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(logdir / f"trace_{os.getpid()}.json"))


def annotate(name: str, device: Optional[torch.device] = None):
    """A span named ``name`` on the profiler's timeline (a context manager)
    while a profiler records; otherwise one shared no-op. Given a CUDA
    ``device``, the span is also clocked on it (see the module): its device
    time is the current stream's time from its entry to its exit, waits
    for the host included. A CPU ``device`` clocks nothing."""
    if not recording():
        return _OFF
    if device is not None and device.type == "cuda":
        return _clocked(name, device)
    return record_function(name)


def _mark(device: torch.device):
    """A timing CUDA event recorded now on ``device``'s current stream."""
    event = torch.cuda.Event(enable_timing=True)
    event.record(torch.cuda.current_stream(device))
    return event


@contextlib.contextmanager
def _clocked(name: str, device: torch.device):
    with record_function(name):
        start = _mark(device)
        try:
            yield
        finally:
            _PENDING.append((name, start, _mark(device)))


def count(name: str, n=1) -> None:
    """Add ``n`` to the process-wide counter ``name``."""
    _COUNTERS[name] = _COUNTERS.get(name, 0) + n


def counters() -> dict:
    """A copy of every counter of this process (see the module), once the
    clocked spans recorded so far are added to ``device_ms.<span>`` and
    ``spans.<span>``: this waits for each one's exit event, the only wait
    the clock makes."""
    while _PENDING:
        name, start, end = _PENDING.popleft()
        end.synchronize()
        count(f"device_ms.{name}", start.elapsed_time(end))
        count(f"spans.{name}")
    return dict(_COUNTERS)


def launches(wrapper) -> int:
    """The kernel launches of a kernel wrapper (a function of ``ops/`` or
    ``probes/``) so far in this process: its counter ``launch.<name>``."""
    return _COUNTERS.get(f"launch.{wrapper.__name__}", 0)


@contextlib.contextmanager
def timed(name: str):
    """A span ``name`` that also adds its host seconds to the counter
    ``name`` (also a decorator). A span nested inside another of the same
    name counts once. For set-up-scale work: it adds no synchronise, so
    device work it queued may still run after it closes."""
    depth = _TIMED_DEPTH.get(name, 0)
    _TIMED_DEPTH[name] = depth + 1
    t0 = time.perf_counter()
    try:
        with annotate(name):
            yield
    finally:
        _TIMED_DEPTH[name] = depth
        if depth == 0:
            count(name, time.perf_counter() - t0)
