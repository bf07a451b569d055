"""The bytes of the GroupNorm layer's own function over the profiled
stretch (``counting.k1_forward_bytes`` / ``k1_backward_bytes``), at
3.35 TB/s, over the device time of every K1 kernel, in percent."""

from h100bench.counting import PEAK_HBM_BYTES


def read(record):
    s = record.get("stretch")
    if s is None or not s["groups"].get("k1"):
        return None
    return 100.0 * s["k1_bytes"] / PEAK_HBM_BYTES / s["groups"]["k1"]
