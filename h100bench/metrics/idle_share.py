"""Percent of the profiled stretch's wall time in which no operation ran on
the device (``trace.Stretch``: the union of kernel and copy intervals)."""


def read(record):
    s = record.get("stretch")
    if s is None:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["wall_s"])
