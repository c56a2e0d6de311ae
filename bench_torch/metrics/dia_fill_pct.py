"""The share of the hybrid split's diagonal slots that hold an entry, in
percent: the program's counters hybrid.diag_entries over hybrid.diag_slots
(its diagonals times M), the share of K6's slot work that carries an
entry."""

from bench_torch.program import counter


def read(record):
    entries, slots = counter("hybrid.diag_entries"), counter("hybrid.diag_slots")
    return 100.0 * entries / slots if entries is not None and slots else None
