"""The program's own spans (``tpu_mednet_torch.utils.tracing``), read after a run.

The program records a span only while a profiler records, so in a run these
are the profiled stretches' spans, every stretch's.  A reading is a span's
total host milliseconds over the served volumes (``serve.copy_back`` spans:
one a volume returned) or over the train steps (``train.step`` spans) they
cover.  Nothing (None) where the span was never recorded, or where the
program has no tracer.
"""

from __future__ import annotations

from typing import Optional


def _totals() -> dict:
    try:
        from tpu_mednet_torch.utils import tracing
    except ImportError:  # a program without the tracer
        return {}
    return tracing.totals()


def ms_per(span: str, unit: str) -> Optional[float]:
    """Total milliseconds of ``span`` over the count of ``unit`` spans."""
    totals = _totals()
    if span not in totals or not totals.get(unit):
        return None
    return 1e3 * totals[span].seconds / totals[unit].count


def ms_per_request(span: str) -> Optional[float]:
    return ms_per(span, "serve.copy_back")


def ms_per_step(span: str) -> Optional[float]:
    return ms_per(span, "train.step")
