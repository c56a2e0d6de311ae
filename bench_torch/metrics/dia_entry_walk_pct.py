"""The share of K6's launches that walked its entry map, in percent: the
program's counters launch.spmm_dia.entries over launch.spmm_dia, the K6
launches that multiplied the diagonals' entries alone and skipped their
stored zeros; nothing to read where the program has no such counter."""

from bench_torch.program import counter


def read(record):
    walks, launches = counter("launch.spmm_dia.entries"), counter("launch.spmm_dia")
    return 100.0 * walks / launches if walks is not None and launches else None
