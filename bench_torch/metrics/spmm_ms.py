"""Host-clock milliseconds a product on the FEM cantilever: the window, from the first submit to the final synchronise, over the products completed."""

from bench_torch.readers import window_ms_per_unit as read  # noqa: F401
