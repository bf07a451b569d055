"""Host milliseconds a train step spent in the program's ``sampler.render``
span: the device sampler's landmark heatmaps: the index upload, the
Gaussians' launches, the cast; the span's total over the profiled stretches,
per step (``h100bench/spans.py``)."""

from h100bench.spans import ms_per_step


def read(record):
    return ms_per_step("sampler.render")
