"""Device milliseconds a product outside the port's SpMM kernels in the
circuit matrix's hybrid products: the head-column and hub-row matmuls, the
gather of B's head rows, the adds and the hub rows' ``index_add_``."""

from bench_torch.readers import outside_spmm_ms as read  # noqa: F401
