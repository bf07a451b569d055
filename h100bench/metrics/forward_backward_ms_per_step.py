"""Host milliseconds a train step spent in the program's
``train.forward_backward`` span: the forward, the loss, ``zero_grad``,
``backward`` and the data-parallel gradient average; the span's total over
the profiled stretches, per step (``h100bench/spans.py``)."""

from h100bench.spans import ms_per_step


def read(record):
    return ms_per_step("train.forward_backward")
