"""Host milliseconds a train step spent in the program's ``train.update`` span:
the gradient norm, the non-finite guard and the optimizer's update; the
span's total over the profiled stretches, per step (``h100bench/spans.py``)."""

from h100bench.spans import ms_per_step


def read(record):
    return ms_per_step("train.update")
