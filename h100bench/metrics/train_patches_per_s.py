"""Patches of every step completed in the window over the window's wall time
(host clock; the window closes with a device synchronisation)."""


def read(record):
    if "patches" not in record:
        return None
    return record["patches"] / record["window_s"]
