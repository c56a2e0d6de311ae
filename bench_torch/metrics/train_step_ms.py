"""Host-clock milliseconds a training step: the window, from the first step's start to the final synchronise, over the steps completed."""

from bench_torch.readers import window_ms_per_unit as read  # noqa: F401
