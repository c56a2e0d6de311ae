"""The share of the ELL pack's padded rows that are virtual rows K5 folds
back into their real row, in percent: the program's counters
ell.fold_rows over ell.rows."""

from bench_torch.program import counter


def read(record):
    folded, rows = counter("ell.fold_rows"), counter("ell.rows")
    return 100.0 * folded / rows if folded is not None and rows else None
