"""The Linear layers' logical FLOPs over the profiled stretch (the family's
``group_work``: ``linear``) at 989 TFLOP/s bf16, over the device time of
their GEMM kernels (the family's ``linear`` group), in percent.  Nothing
where the configuration's family has no such group."""

from h100bench.counting import PEAK_BF16_FLOPS


def read(record):
    s = record.get("stretch")
    if s is None or not s["groups"].get("linear") or "linear" not in s.get("work", {}):
        return None
    return 100.0 * s["work"]["linear"]["flops"] / PEAK_BF16_FLOPS / s["groups"]["linear"]
