"""Runs a row of K4's host scan: the program's counters edge.runs over
edge.rows (the padded rows that have a run). Each run ends in a flush into
its row, at precise level 2 an acc_step of the compensated pair, so this
is the flushes a row pays."""

from bench_torch.program import counter


def read(record):
    runs, rows = counter("edge.runs"), counter("edge.rows")
    return runs / rows if runs is not None and rows else None
