"""Device milliseconds a training step outside the port's SpMM kernels: the value scatter, K1's per-call operand tiles, the SDDMM, the pads, the loss and the optimizer."""

from bench_torch.readers import outside_spmm_ms as read  # noqa: F401
