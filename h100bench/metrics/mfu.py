"""Logical conv FLOPs of the window's work (train: 3 x the forward a
sample; serve: the grid's own tiles, not the repeated tail corners) over
the window's wall time, both outside the profiled stretches, in percent of
one H100's 989 TFLOP/s bf16 dense."""

from h100bench.counting import PEAK_BF16_FLOPS


def read(record):
    if not record.get("flops"):
        return None
    return 100.0 * record["flops"] / record["untraced_s"] / PEAK_BF16_FLOPS
