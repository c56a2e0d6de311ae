"""The share of the hybrid split's dense hub planes that hold an entry, in
percent: the program's counters hybrid.dense_entries over
hybrid.dense_slots (M x H head columns plus R x K hub rows), the share of
the hub matmuls' work that carries an entry."""

from bench_torch.program import counter


def read(record):
    entries, slots = counter("hybrid.dense_entries"), counter("hybrid.dense_slots")
    return 100.0 * entries / slots if entries is not None and slots else None
