"""Host milliseconds a served volume spent in the program's ``serve.prepare``
span: everything before the pipeline: the device and placement checks,
``model.eval()``, the shapes and affines, the HBM guard, the f16 read; the
span's total over the profiled stretches, per volume returned
(``h100bench/spans.py``)."""

from h100bench.spans import ms_per_request


def read(record):
    return ms_per_request("serve.prepare")
