"""Logical rows a tile of K5's host plan, the rows that share each B row
the kernel stages: the program's counters ell.tile_rows over ell.tiles
(made at upload on a card only)."""

from bench_torch.program import counter


def read(record):
    rows, tiles = counter("ell.tile_rows"), counter("ell.tiles")
    return rows / tiles if rows is not None and tiles else None
