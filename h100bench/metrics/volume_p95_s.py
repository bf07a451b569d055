"""The 95th percentile of the window's request seconds, from the call of
``predict_volumes_on_device`` to its uint8 mask on the host (linear
interpolation between order statistics), over the requests outside the
profiled stretches.  A per-layer reading: the host's share of a request
swings between runs by more than an end-to-end bound may hold (PERF.md)."""

import numpy as np


def read(record):
    lat = record.get("latencies")
    if not lat:
        return None
    return float(np.percentile(np.asarray(lat), 95))
