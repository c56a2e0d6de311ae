"""Device milliseconds a product outside the port's SpMM kernels: the plan's pads and the rest of SpmmPlan.__call__ (operands in the L2)."""

from bench_torch.readers import outside_spmm_ms as read  # noqa: F401
