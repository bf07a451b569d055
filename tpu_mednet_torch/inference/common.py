"""Shared plumbing for on-device inference.

Counterpart of ``tpu_mednet/inference/common.py:20-60``: the per-task
predictor cache and the depth-1 dispatch/finalize pipeline over volumes.
CUDA launches are asynchronous, so dispatching the next volume (upload,
gathers, forwards, stitch) queues its work on the card while the previous
volume's result is copied back to the host — the same overlap JAX's async
dispatch gave.  TTA and round-robin multi-device placement are not ported
yet.
"""

from __future__ import annotations

import weakref
from typing import Callable, Dict, Hashable, Iterable, Tuple


def per_task_cache(cache: Dict[int, Dict], task, key: Hashable,
                   build: Callable[[], object]):
    """Get-or-build a per-task cached object (e.g. a predictor).

    Predictors are cached per task and evicted when the task is
    garbage-collected (``weakref.finalize``; the outer key is ``id(task)``),
    so long-lived processes cycling tasks don't pin dead predictors.
    ``key`` is the static configuration of the predictor.
    """
    tid = id(task)
    if tid not in cache:
        cache[tid] = {}
        weakref.finalize(task, cache.pop, tid, None)
    per_task = cache[tid]
    if key not in per_task:
        per_task[key] = build()
    return per_task[key]


def run_pipelined(items: Iterable[Tuple], dispatch: Callable,
                  finalize: Callable) -> None:
    """Depth-1 software pipeline: dispatch item i+1, then finalize item i.

    ``dispatch`` queues an item's device work and returns without waiting;
    ``finalize`` waits for one (the device-to-host copy) and stores it.
    """
    pending = None
    for item in items:
        queued = dispatch(*item)
        if pending is not None:
            finalize(*pending)
        pending = queued
    if pending is not None:
        finalize(*pending)
