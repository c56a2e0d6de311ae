"""K1's share of its roofline (readers.k1_roofline), in repeated products whose operands sit in the L2."""

from bench_torch.readers import k1_roofline as read  # noqa: F401
