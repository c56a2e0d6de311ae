"""Device milliseconds a product outside the port's SpMM kernels: the plan's pads of B and C and what else SpmmPlan.__call__ puts on the card (cantilever)."""

from bench_torch.readers import outside_spmm_ms as read  # noqa: F401
