"""Asynchronous host-to-device prefetching.

Counterpart of ``tpu_mednet/data/prefetch.py``: a background thread runs
the host sampler and puts each batch on the device ahead of use, so the
train step does not wait on the host (double buffering).  On CUDA each
batch goes from pinned memory with ``non_blocking=True`` on a copy stream
of its own; the consumer's stream waits for that copy's event before it
uses the batch, so the copy overlaps the previous step's kernels.  A batch
already in pinned memory (the native pipeline's pool,
``data/native_loader.py``) is copied as it is, and a callable it carries
under ``ON_COPIED`` is called with the copy's event, so its buffer is
reused only after the copy has ended.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator

import torch

_SENTINEL = object()
BUFFER_SIZE = 2                # batches in flight: double buffering
ARRAY_KEYS = ("data", "label")  # the entries moved to the device
ON_COPIED = "on_copied"         # a batch's hook that takes its copy's CUDA event


def _to_device(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A channels-last (N, C, X, Y, Z) CPU tensor to ``device``, through its
    contiguous (N, X, Y, Z, C) buffer in pinned memory."""
    buf = t.permute(0, 2, 3, 4, 1)
    if not buf.is_pinned():
        buf = buf.pin_memory()
    return buf.to(device, non_blocking=True).permute(0, 4, 1, 2, 3)


def device_prefetch(host_iter: Iterator[Dict[str, object]],
                    device) -> Iterator[Dict[str, object]]:
    """Iterate ``host_iter`` on a background thread, moving its tensors to
    ``device``; other entries pass through.  Errors in the producer are
    re-raised at the consumer."""
    device = torch.device(device)
    stream = torch.cuda.Stream(device) if device.type == "cuda" else None
    q: queue.Queue = queue.Queue(maxsize=BUFFER_SIZE)
    stop = threading.Event()

    def put(batch):
        out = dict(batch)
        on_copied = out.pop(ON_COPIED, None)
        if stream is None:
            for k in ARRAY_KEYS:
                if k in out:
                    out[k] = out[k].to(device)
            return out, None
        with torch.cuda.stream(stream):
            for k in ARRAY_KEYS:
                if k in out:
                    out[k] = _to_device(out[k], device)
            copied = stream.record_event()
        if on_copied is not None:
            on_copied(copied)
        return out, copied

    def producer():
        try:
            for batch in host_iter:
                if stop.is_set():
                    return
                q.put(put(batch))
        except BaseException as e:  # surface producer errors to the consumer
            q.put(e)
            return
        q.put(_SENTINEL)

    thread = threading.Thread(target=producer, daemon=True, name="tpu-mednet-prefetch")
    thread.start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                break
            if isinstance(item, BaseException):
                raise item
            batch, copied = item
            if copied is not None:
                current = torch.cuda.current_stream(device)
                current.wait_event(copied)
                for k in ARRAY_KEYS:
                    if k in batch:
                        batch[k].record_stream(current)
            yield batch
    finally:
        # the consumer may abandon the epoch early: unblock the producer,
        # let it see ``stop``, and join it, so no thread outlives the epoch
        # or draws from the sampler's generator during the next one
        stop.set()
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass
        thread.join()
