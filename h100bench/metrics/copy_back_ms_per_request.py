"""Host milliseconds a served volume spent in the program's ``serve.copy_back``
span: the mask's copy to the host, ``.numpy()``, its store into the result;
the span's total over the profiled stretches, per volume returned
(``h100bench/spans.py``)."""

from h100bench.spans import ms_per_request


def read(record):
    return ms_per_request("serve.copy_back")
