"""The device's idle share of the traced window, in percent (train cells)."""

from bench_torch.readers import idle_pct as read  # noqa: F401
