"""Host milliseconds a train step spent in the program's ``train.augment``
span: the dtype cast, the augmentation's draws and apply, the slab cut; the
span's total over the profiled stretches, per step (``h100bench/spans.py``)."""

from h100bench.spans import ms_per_step


def read(record):
    return ms_per_step("train.augment")
