"""Spans at the port's layer boundaries, recorded while a profiler records.

``with span("serve.upload", request=i): ...`` times one step of a layer.  A
span records exactly while a ``torch.profiler`` session is recording
(``torch.autograd.profiler._is_profiler_enabled``, a module flag read at the
span's start); otherwise ``span`` returns one shared no-op object, allocates
nothing and opens no profiler range.  There is no other switch: the one
operator use is ``Trainer(profile_dir=...)``, whose Chrome trace then holds
the program's spans, and any caller that profiles a stretch of its own work
records them too.

A recorded span (``Span``) holds its name, its start and end on
``time.perf_counter_ns()``, its own id, its parent's (the innermost span
open on the same thread: each thread keeps its own stack, so a span of
another thread never nests under the main thread's), its request (a root span takes
the next number of a process-wide sequence; its children carry it) and its
item (the ``request`` argument: in serving, the volume's index within the
call).  Each span also opens a ``torch.profiler.record_function`` range
named ``PREFIX + name``, a prefix no aten operator carries: the same span
in the profiler's trace, on the device trace's clock, counted there as a
user annotation and not as device work, so a reader of the trace can put
each idle gap of the device down to the innermost program span open at its
start.

Records stay in memory, the newest ``MAX_SPANS`` of them, and nothing is
written while a span runs: ``spans()`` returns them, ``totals()`` sums them
by name (count, seconds, and self seconds: a span's time less what its
children cover), ``reset()`` forgets them.

The spans, by layer:

- serving entry (``inference/common.py`` ``predict_on_device``):
  ``serve.call`` (root, one call), ``serve.prepare`` (the checks,
  ``model.eval()``, shapes and affines, the HBM guard, the f16 read), and per
  volume ``serve.upload``, ``serve.launch`` (the tile plan and the
  predictor: pad, K2, forwards, stitch writes, crop), ``serve.wait`` (the
  host waiting for the volume's queued work) and ``serve.copy_back``;
- device sampler (``data/device_sampler.py``): ``sampler.batch`` (root, one
  batch), ``sampler.draw`` (the host's subject and corner draws),
  ``sampler.render`` (the landmarks' heatmaps);
- model step (``train/step.py``): ``train.step`` (root), ``train.augment``,
  ``train.forward_backward``, ``train.update``;
- Swin UNETR's forward (``models/swin_unetr.py``): ``swin.encoder`` (the
  patch embedding, the four stages and the five hidden states' LayerNorms)
  and ``swin.decoder`` (the residual conv blocks, the up blocks and the
  head), inside ``train.forward_backward`` or ``serve.launch``;
- spatial partitioning (``parallel/halo.py``): ``sp.halo_exchange``.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import torch
import torch.autograd.profiler as _profiler

PREFIX = "tpu_mednet_torch."
MAX_SPANS = 100_000


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: Optional[int]   # the enclosing span's id, None for a root
    request: int            # the root's number, shared by its children
    item: Optional[int]     # the ``request`` argument of ``span``


class Total(NamedTuple):
    count: int
    seconds: float
    self_seconds: float


_records: collections.deque = collections.deque(maxlen=MAX_SPANS)
_lock = threading.Lock()
_local = threading.local()
_ids = itertools.count(1)
_requests = itertools.count(1)


def enabled() -> bool:
    """Whether a profiler session is recording, so spans record."""
    return _profiler._is_profiler_enabled


class _Off:
    """The shared span of an untraced call: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Open:
    __slots__ = ("name", "item", "id", "parent", "request", "start", "range", "stack")

    def __init__(self, name: str, item: Optional[int]):
        self.name, self.item = name, item

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        parent = stack[-1] if stack else None
        self.stack, self.id = stack, next(_ids)
        self.parent = parent.id if parent is not None else None
        self.request = parent.request if parent is not None else next(_requests)
        self.range = torch.profiler.record_function(PREFIX + self.name)
        self.range.__enter__()
        stack.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        self.stack.pop()
        self.range.__exit__(*exc)
        with _lock:
            _records.append(Span(self.name, self.start, end, self.id, self.parent,
                                 self.request, self.item))
        return False


def span(name: str, request: Optional[int] = None):
    """A context manager timing ``name`` while a profiler records; the
    shared no-op otherwise.  ``request`` is the item's index within its
    root (a served volume's within the call)."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Open(name, request)


def spans() -> List[Span]:
    """The recorded spans, oldest first."""
    with _lock:
        return list(_records)


def totals() -> Dict[str, Total]:
    """Per span name: its count, total seconds and self seconds (each
    span's time less its children's, which nest inside it one after
    another on its thread)."""
    recs = spans()
    covered: Dict[int, int] = collections.defaultdict(int)
    for s in recs:
        if s.parent is not None:
            covered[s.parent] += s.end_ns - s.start_ns
    sums: Dict[str, list] = {}
    for s in recs:
        t = sums.setdefault(s.name, [0, 0, 0])
        t[0] += 1
        t[1] += s.end_ns - s.start_ns
        t[2] += s.end_ns - s.start_ns - covered.get(s.id, 0)
    return {name: Total(n, total / 1e9, own / 1e9) for name, (n, total, own) in sums.items()}


def reset() -> None:
    """Forget every recorded span."""
    with _lock:
        _records.clear()
