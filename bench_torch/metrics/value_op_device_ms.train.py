"""Device milliseconds a training step in the port's value op, its forward
and its backward (the spans sx.autodiff.forward and sx.autodiff.backward):
the program's counters device_ms.sx.autodiff.forward and .backward, their
CUDA-event clock in the traced window, over the window's steps; the step's
time less this is the caller's loss, zero_grad, Adam and the card's idle.
Nothing to read where the program clocks no span: off a card, or in a
program without the clock."""

from bench_torch.program import counter


def read(record):
    fwd, bwd = counter("device_ms.sx.autodiff.forward"), counter("device_ms.sx.autodiff.backward")
    tr = record.trace
    return (fwd + bwd) / tr.units if None not in (fwd, bwd) and tr and tr.units else None
