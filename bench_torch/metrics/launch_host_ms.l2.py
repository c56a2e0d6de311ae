"""Host milliseconds a product in the kernel wrappers' spans (sx.kernel.*), less the profiler's cost of the spans: the launch's checks, its grid, the library call and the launch itself, operands in the L2."""

from bench_torch.program import kernel_host_ms as read  # noqa: F401
