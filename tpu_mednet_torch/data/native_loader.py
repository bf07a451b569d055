"""Native batch pipeline over a ``PatchSampler``.

Counterpart of ``tpu_mednet/data/native_loader.py`` (the reference's
``DataLoader(dataset, num_workers=..., pin_memory=True)``,
segmentation.py:122-131): index drawing (class-balanced, seeded) stays in
Python and matches ``PatchSampler.batches`` draw for draw, while the
per-batch heavy lifting (crop, f16->f32, channels-last transpose) runs in
one fused native pass (``tpu_mednet_torch/native/patchloader.cpp``).
Batches are byte-equal to the numpy sampler's and to the JAX package's
native pipeline under the same seed (tests/test_torch_native_loader.py).

**One thread.**  The pipeline has no thread of its own: the Trainer hands
``batches()`` to ``data/prefetch.py``'s ``device_prefetch``, whose producer
thread runs the native pass (ctypes releases the GIL), then enqueues the
batch's copy to the card.  The JAX package runs a loader thread in series
with its prefetch thread; here one thread suffices because the copy is
only enqueued (``non_blocking``), and one thread is what makes the pinned
pool below safe to reuse: the thread that fills a buffer is the one that
learns when its copy has been enqueued.

**Buffers.**  For a CUDA consumer (``pinned=True``) batches are assembled
straight into a pool of pinned ``(N, X, Y, Z, C)`` buffers, which
``device_prefetch`` copies without staging them again.  A buffer returns
to the pool only after the CUDA event recorded behind its copy has
completed: the batch carries a hook under ``prefetch.ON_COPIED`` that
``device_prefetch`` calls with that event.  A refcount gate (the JAX
package's) is not enough there, since the host tensor's last reference
drops as soon as ``.to(non_blocking=True)`` returns, while the copy engine
still reads it.  The pool holds at most ``BUFFER_SIZE + 3`` pairs, the most
that can be in flight: the consumer's batch (its stream waits on the copy,
the host does not), ``BUFFER_SIZE`` batches in ``device_prefetch``'s queue,
one the producer holds while it blocks to enqueue it, and the one being
assembled.  With every pair in flight, the oldest copy's event is waited
on; copies run in order on one stream, so that wait is the shortest.

For a CPU consumer the buffers are numpy arrays reused by the JAX
package's refcount rule: a pair is free when nothing outside the pool
references it (the yielded tensors hold their arrays alive), so a batch a
consumer still holds is never overwritten.
"""

from __future__ import annotations

import logging
import sys
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from tpu_mednet_torch import native
from tpu_mednet_torch.data.patch_sampler import PatchSampler
from tpu_mednet_torch.data.prefetch import BUFFER_SIZE, ON_COPIED
from tpu_mednet_torch.data.sampling import get_labeled_position, get_random_patch_indices

logger = logging.getLogger(__name__)

# pinned pairs that can be in flight at once (module docstring)
PINNED_POOL_LIMIT = BUFFER_SIZE + 3
_TORCH_DTYPES = {np.float32: torch.float32, np.uint8: torch.uint8}
UNAVAILABLE = ("native loader requested but unavailable "
               "(library missing or transform hook set)")


def _channels_first(t: torch.Tensor) -> torch.Tensor:
    """(N, X, Y, Z, C) buffer -> the port's logical (N, C, X, Y, Z) view."""
    return t.permute(0, 4, 1, 2, 3)


class _HostPool:
    """numpy (data, label) pairs, reused when nothing outside the pool
    references them (the JAX package's rule)."""

    def __init__(self, shapes):
        self.shapes = shapes
        self.pairs: List[tuple] = []

    def acquire(self):
        for d, l in self.pairs:
            # refs while free: pool tuple + loop locals + getrefcount arg
            if sys.getrefcount(d) <= 3 and sys.getrefcount(l) <= 3:
                return d, l, None
        d, l = (np.empty(shape, dtype) for shape, dtype in self.shapes)
        self.pairs.append((d, l))
        return d, l, None


class PinnedPool:
    """Pinned (data, label) pairs, each free once the event of its copy to
    the card has completed (module docstring).  ``acquire`` returns the
    pair and the hook that takes that event; a pair handed out must report
    its copy before the next ``acquire``."""

    def __init__(self, shapes, limit: int = PINNED_POOL_LIMIT):
        self.shapes = shapes
        self.limit = limit
        self.slots: List[list] = []   # [pair, event or None], oldest first
        self._pending: Optional[list] = None

    def _new_pair(self):
        return tuple(torch.empty(shape, dtype=_TORCH_DTYPES[dtype], pin_memory=True)
                     for shape, dtype in self.shapes)

    def acquire(self):
        if self._pending is not None:
            raise RuntimeError(
                "a pinned batch was not copied before the next was assembled: pinned "
                "batches must go through data/prefetch.py's device_prefetch")
        free = next((i for i, s in enumerate(self.slots) if s[1].query()), None)
        if free is not None:
            slot = self.slots.pop(free)
        elif len(self.slots) < self.limit:
            slot = [self._new_pair(), None]
        else:  # every pair in flight: wait for the oldest copy
            slot = self.slots.pop(0)
            slot[1].synchronize()
        slot[1] = None
        self._pending = slot

        def copied(event) -> None:
            slot[1] = event
            self.slots.append(slot)
            self._pending = None

        d, l = slot[0]
        return d, l, copied


class NativeBatchPipeline:
    """Iterate epochs of channels-last batches with native assembly.

    Wraps (does not subclass) a ``PatchSampler``: consumes its preloaded
    volumes, rng, class probabilities and any-masks so the drawn patch
    sequence is IDENTICAL to ``sampler.batches(...)`` under the same seed.
    ``pinned`` assembles into pinned buffers for a CUDA consumer.  It needs
    the native library and never falls back: ``make_batch_source`` picks
    the route.  (The JAX package also declines a ``transform`` hook and a
    lazy ``preload=False`` sampler; the port's sampler has neither.)
    """

    def __init__(self, sampler: PatchSampler, pinned: bool = False):
        self.sampler = sampler
        self.pinned = pinned

    def __len__(self) -> int:
        return len(self.sampler)

    def _c_contiguous_volumes(self) -> None:
        """The native pass reads C-contiguous volumes; a reader may preload
        another layout (a NIfTI volume is Fortran-ordered).  Such volumes are
        copied to C order once, in place in the sampler: the same values, so
        the numpy sampler's crops do not change."""
        s = self.sampler
        for vols in (s.images, s.labels, s.heatmaps):
            for i, v in enumerate(vols if vols is not None else ()):
                if not v.flags.c_contiguous:
                    vols[i] = np.ascontiguousarray(v)

    # -- index drawing (mirrors PatchSampler.sample minus the array work) --

    def _draw(self, idx: int):
        s = self.sampler
        idx = idx % len(s.images)
        selected_class = 0
        pos = None
        if s.class_probabilities is not None:
            selected_class = int(
                s.rng.choice(len(s.class_probabilities), p=s.class_probabilities))
            if selected_class > 0:
                pos = get_labeled_position(
                    np.asarray(s.labels[idx][-1]), selected_class,
                    label_any=s._label_ax2_any[idx][selected_class], rng=s.rng)
        ini, _ = get_random_patch_indices(s.patch_size, s.images[idx].shape[1:], pos=pos,
                                          rng=s.rng)
        return idx, ini, selected_class

    def _assemble(self, chunk, pool) -> Dict[str, object]:
        s = self.sampler
        draws = [self._draw(int(i)) for i in chunk]
        subj = [d[0] for d in draws]
        out_data, out_label, copied = pool.acquire()
        native.assemble_batch(
            [s.images[i] for i in subj],
            [s.labels[i] for i in subj],
            [s.heatmaps[i] for i in subj] if s.heatmaps is not None else None,
            np.stack([d[1] for d in draws]).astype(np.int64),
            s.patch_size,
            out_data,
            out_label,
        )
        if isinstance(out_data, np.ndarray):
            out_data, out_label = torch.from_numpy(out_data), torch.from_numpy(out_label)
        batch = {
            "data": _channels_first(out_data),
            "label": _channels_first(out_label),
            "subject_key": [s.subject_keys[i] for i in subj],
            "selected_class": np.asarray([d[2] for d in draws]),
        }
        if copied is not None:
            batch[ON_COPIED] = copied
        return batch

    # -- epoch iteration ---------------------------------------------------

    def batches(self, batch_size: int, shuffle: bool = True) -> Iterator[Dict[str, object]]:
        """One epoch; the order and draws of ``PatchSampler.batches``.  The
        trailing partial batch is dropped, as the numpy sampler does and as
        the JAX Trainer asks of its pipeline (``drop_last=True``)."""
        s = self.sampler
        order = np.arange(len(s))
        if shuffle:
            s.rng.shuffle(order)
        if 0 < len(order) < batch_size:
            # the numpy sampler's tiny-epoch pad (its one-time warning too):
            # an epoch must not silently yield nothing
            if not s._pad_warned:
                logger.warning(
                    "epoch has %d items (< batch_size %d): padding the batch by "
                    "re-drawing %d samples with replacement", len(order), batch_size,
                    batch_size - len(order))
                s._pad_warned = True
            extra = s.rng.choice(order, size=batch_size - len(order), replace=True)
            order = np.concatenate([order, extra])
        chunks = [order[start:start + batch_size]
                  for start in range(0, len(order) - batch_size + 1, batch_size)]
        if not chunks:
            return

        self._c_contiguous_volumes()
        px, py, pz = (int(p) for p in s.patch_size)
        c_img = int(s.images[0].shape[0])
        c_lbl = int(s.labels[0].shape[0]) + (
            int(s.heatmaps[0].shape[0]) if s.heatmaps is not None else 0)
        shapes = (((batch_size, px, py, pz, c_img), np.float32),
                  ((batch_size, px, py, pz, c_lbl), np.uint8))
        pool = PinnedPool(shapes) if self.pinned else _HostPool(shapes)
        for chunk in chunks:
            yield self._assemble(chunk, pool)


def make_batch_source(sampler: PatchSampler, use_native: Optional[bool] = None,
                      pinned: bool = False):
    """Pick the batch source for a sampler.

    ``use_native=None`` auto-selects: native when the library builds (a
    failed build is logged with the compiler's error, then the numpy
    sampler is used); ``True`` requires it and raises otherwise; ``False``
    is the numpy sampler.  ``pinned`` is for a CUDA consumer.  Returns an
    object with a ``batches(batch_size, shuffle=...)`` method.
    """
    if use_native is False:
        return sampler
    if native.available():
        logger.info("using native batch pipeline (patchloader)")
        return NativeBatchPipeline(sampler, pinned=pinned)
    if use_native:
        cause = RuntimeError(native.BUILD_ERROR) if native.BUILD_ERROR else None
        raise RuntimeError(UNAVAILABLE) from cause
    return sampler
