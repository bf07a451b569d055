"""Volumes returned as host masks in the window, times 60, over its wall time."""


def read(record):
    if "requests" not in record:
        return None
    return record["requests"] * 60.0 / record["window_s"]
