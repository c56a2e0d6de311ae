"""Megabytes of padded B and C that the plan makes a product: the program's counters plan.pad_bytes over plan.calls (cantilever)."""

from bench_torch.program import counter


def read(record):
    made, calls = counter("plan.pad_bytes"), counter("plan.calls")
    return made / calls / 1e6 if made is not None and calls else None
