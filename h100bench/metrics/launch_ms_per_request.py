"""Host milliseconds a served volume spent in the program's ``serve.launch``
span: the tile plan and the predictor call (the pad, the output's zeros,
each batch's K2, forward and stitch writes, the crop): the host queueing the
volume's work; the span's total over the profiled stretches, per volume
returned (``h100bench/spans.py``)."""

from h100bench.spans import ms_per_request


def read(record):
    return ms_per_request("serve.launch")
