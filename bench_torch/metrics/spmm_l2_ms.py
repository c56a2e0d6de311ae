"""Host-clock milliseconds a product on a matrix whose B and C sit inside the L2, where the per-call wrapper weighs: the window over the products completed."""

from bench_torch.readers import window_ms_per_unit as read  # noqa: F401
