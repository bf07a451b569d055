"""Host milliseconds a served volume spent in the program's ``serve.upload``
span: ``upload_volume``: the pinned staging, the queued host-to-device copy,
the layout permute; the span's total over the profiled stretches, per volume
returned (``h100bench/spans.py``)."""

from h100bench.spans import ms_per_request


def read(record):
    return ms_per_request("serve.upload")
