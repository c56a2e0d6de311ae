"""Profiling hooks.

The PyTorch counterpart of ``sextans_tpu.utils.profiling``: ``trace``
records ``torch.profiler`` (host and, where there is a card, CUDA activity)
around any code and writes a Chrome trace (``chrome://tracing``, Perfetto);
``annotate`` names a span on that timeline.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile, record_function

__all__ = ["trace", "annotate"]


@contextlib.contextmanager
def trace(logdir=None):
    """Record a trace of the block and write it to
    ``<logdir>/trace_<pid>.json`` (``logdir`` defaults to
    ``$TMPDIR/sextans_tpu_torch_trace``); yields the ``torch.profiler``
    profile, whose ``key_averages()`` sum the device time by kernel.

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


def annotate(name: str):
    """A named span on the profiler's timeline (a context manager)."""
    return record_function(name)
