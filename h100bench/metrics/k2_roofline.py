"""The tiles the profiled stretch gathered, read once in f16 and written
once in the compute dtype (``counting.k2_bytes``), at 3.35 TB/s, over the
``gather_stores`` kernels' device time, in percent."""

from h100bench.counting import PEAK_HBM_BYTES


def read(record):
    s = record.get("stretch")
    if s is None or "k2_bytes" not in s or not s["groups"].get("k2"):
        return None
    return 100.0 * s["k2_bytes"] / PEAK_HBM_BYTES / s["groups"]["k2"]
