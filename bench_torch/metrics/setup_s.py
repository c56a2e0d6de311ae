"""Host-clock seconds from the process's start to the first timed unit:
imports, the card's start, the kernel library's load (its build, in a
checkout's first run), the matrix, its pack and upload, the inputs and the
warm-up of every shape the cell uses."""


def read(record):
    return record.setup_s
