"""Host seconds of the program's upload in set-up (its counter upload_s: the packed arrays' copies to the device, the host scans, K1's operand tiles, the value op's scatter maps)."""

from bench_torch.program import counter


def read(record):
    return counter("upload_s")
