"""Host milliseconds a served volume spent in the program's ``serve.wait``
span: the host waiting for the volume's queued work, a stream
synchronisation before the copy back; the span's total over the profiled
stretches, per volume returned (``h100bench/spans.py``)."""

from h100bench.spans import ms_per_request


def read(record):
    return ms_per_request("serve.wait")
