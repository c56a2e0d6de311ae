"""Host seconds of loading the program's kernel library, or of compiling it in a checkout's first run (its counter library_s)."""

from bench_torch.program import counter


def read(record):
    return counter("library_s")
