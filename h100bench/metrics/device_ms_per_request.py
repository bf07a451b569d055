"""Device milliseconds a request in the profiled stretch: the busy time
(the union of kernel and copy intervals) over the requests it served.  It
leaves out the host's share of a request, which spreads from run to run
far more than the device's (PERF.md)."""


def read(record):
    s = record.get("stretch")
    if s is None or not s.get("requests"):
        return None
    return 1e3 * s["busy_s"] / s["requests"]
