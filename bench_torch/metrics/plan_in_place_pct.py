"""The share of the plan's calls that handed the ELL gather kernel (K5) B, C and the output at their real size, in percent: the program's counters plan.in_place over plan.calls; nothing to read where the program has no such counter."""

from bench_torch.program import counter


def read(record):
    in_place, calls = counter("plan.in_place"), counter("plan.calls")
    return 100.0 * in_place / calls if in_place is not None and calls else None
