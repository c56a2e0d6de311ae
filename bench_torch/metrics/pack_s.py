"""Host seconds of the program's packers in set-up (its counter pack_s: pack, pack_mxu, pack_edge, pack_ell, slot_map)."""

from bench_torch.program import counter


def read(record):
    return counter("pack_s")
