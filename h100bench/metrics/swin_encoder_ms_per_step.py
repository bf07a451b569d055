"""Host milliseconds a train step spent in the program's ``swin.encoder``
span (Swin UNETR's patch embedding, four stages and hidden-state
LayerNorms, forward only: the backward runs outside it), the span's total
over the profiled stretches, per step (``h100bench/spans.py``).  Nothing
where the program records no such span."""

from h100bench.spans import ms_per_step


def read(record):
    return ms_per_step("swin.encoder")
