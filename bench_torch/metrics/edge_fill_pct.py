"""The share of the edge pack's slots that hold an entry, in percent: the
program's counters edge.entries over edge.slots (its chunks times
edge_chunk), the share of K4's streamed records that carry an entry."""

from bench_torch.program import counter


def read(record):
    entries, slots = counter("edge.entries"), counter("edge.slots")
    return 100.0 * entries / slots if entries is not None and slots else None
