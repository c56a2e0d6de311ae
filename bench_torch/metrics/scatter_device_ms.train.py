"""Device milliseconds a training step in the value scatter into A's and
A^T's packs (the span sx.autodiff.scatter): the program's counter
device_ms.sx.autodiff.scatter, its CUDA-event clock of those spans in the
traced window, over the window's steps. Nothing to read where the program
clocks no span: off a card, or in a program without the clock."""

from bench_torch.program import counter


def read(record):
    ms, tr = counter("device_ms.sx.autodiff.scatter"), record.trace
    return ms / tr.units if ms is not None and tr and tr.units else None
