"""Host milliseconds a train step spent in the program's ``sampler.draw`` span:
the device sampler's host draws of subjects and corners, with the
class-balanced lookups; the span's total over the profiled stretches, per
step (``h100bench/spans.py``)."""

from h100bench.spans import ms_per_step


def read(record):
    return ms_per_step("sampler.draw")
