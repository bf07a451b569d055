"""The logical conv FLOPs the profiled stretch gave the convolutions (train:
its steps; serve: every tile of its batches, the repeated tail corners
too), at 989 TFLOP/s bf16, over the device time of the conv kernels
(cuDNN's fprop, dgrad and wgrad, grouped by name in ``trace.group_of``),
in percent."""

from h100bench.counting import PEAK_BF16_FLOPS


def read(record):
    s = record.get("stretch")
    if s is None or not s["groups"].get("conv"):
        return None
    flops = s.get("conv_flops", s["flops"])
    return 100.0 * flops / PEAK_BF16_FLOPS / s["groups"]["conv"]
