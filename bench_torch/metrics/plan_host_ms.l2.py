"""Host milliseconds a product in the plan's own span (sx.plan.call) less the kernel wrapper's inside it, and less the profiler's cost of the spans: the pads, the checks and the output's slice, operands in the L2."""

from bench_torch.program import plan_self_ms as read  # noqa: F401
