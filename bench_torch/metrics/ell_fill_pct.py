"""The share of the ELL pack's slots that hold an entry, in percent: the
program's counters ell.entries over ell.slots (padded rows times R), the
share of K5's slot work that carries an entry."""

from bench_torch.program import counter


def read(record):
    entries, slots = counter("ell.entries"), counter("ell.slots")
    return 100.0 * entries / slots if entries is not None and slots else None
