"""K1's share of its roofline (readers.k1_roofline), in the cantilever's repeated products."""

from bench_torch.readers import k1_roofline as read  # noqa: F401
