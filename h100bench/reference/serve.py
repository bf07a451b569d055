"""The reference of sliding-window prediction, in plain PyTorch and numpy.

The reference's grid (``midasmednet/dataset.py:349-510``): the stride is
``patch - 2 * overlap``; the volume is zero-padded by ``overlap`` in front
and ``overlap + (-size) % stride`` behind; tile ``i`` starts at ``i *
stride`` of the padded volume and its core, the tile without ``overlap``
on every side, is written at ``i * stride`` of the volume, clipped to it.
The cores tile the volume disjointly, so every voxel has one tile.

A served mask is judged voxel by voxel: the widest gap by which the
reference's logit of the served class lies below its best logit.
"""

from __future__ import annotations

import itertools
from typing import Callable, Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from h100bench.reference.precision import exact_fp32


def grid(shape: Sequence[int], patch: Sequence[int], overlap: Sequence[int]):
    """(corners in the padded volume, per-axis padding (before, after))."""
    stride = [p - 2 * o for p, o in zip(patch, overlap)]
    counts = [-(-s // st) for s, st in zip(shape, stride)]
    pads = [(o, o + (-s) % st) for s, o, st in zip(shape, overlap, stride)]
    corners = [tuple(i * st for i, st in zip(idx, stride))
               for idx in itertools.product(*(range(n) for n in counts))]
    return corners, pads


def core_logits(family, cfg: dict, params: Dict[str, torch.Tensor], volume: np.ndarray,
                patch: Sequence[int], overlap: Sequence[int], rows: int, device,
                quant: Optional[Callable] = None
                ) -> Iterator[Tuple[Tuple[slice, ...], torch.Tensor]]:
    """(the volume's voxels a core covers, their fp32 logits (K, ...)) for
    every tile of ``volume`` ((C, X, Y, Z) f16, on the host), ``rows``
    tiles a forward of ``family``'s reference."""
    shape = volume.shape[1:]
    corners, pads = grid(shape, patch, overlap)
    padded = torch.from_numpy(np.pad(volume.astype(np.float32), [(0, 0)] + pads)).to(device)
    for s in range(0, len(corners), rows):
        block = corners[s:s + rows]
        tiles = torch.stack([padded[:, x:x + patch[0], y:y + patch[1], z:z + patch[2]]
                             for x, y, z in block])
        with torch.no_grad(), exact_fp32():
            logits = family.forward(cfg, params, tiles, quant)
        for corner, tile in zip(block, logits):
            ends = [min(c + p - 2 * o, n) for c, p, o, n in zip(corner, patch, overlap, shape)]
            where = tuple(slice(c, e) for c, e in zip(corner, ends))
            core = tile[:, overlap[0]:overlap[0] + ends[0] - corner[0],
                        overlap[1]:overlap[1] + ends[1] - corner[1],
                        overlap[2]:overlap[2] + ends[2] - corner[2]]
            yield where, core


def widest_gap(family, cfg: dict, params: Dict[str, torch.Tensor], volume: np.ndarray,
               served: np.ndarray, patch, overlap, rows: int, device) -> float:
    """The largest (best logit - logit of the served class) over the
    voxels of ``volume``; ``served`` is its (1, X, Y, Z) uint8 mask."""
    worst = 0.0
    for where, ref in core_logits(family, cfg, params, volume, patch, overlap, rows, device):
        cls = torch.from_numpy(np.ascontiguousarray(served[(0, *where)])).to(device).long()
        if int(cls.max()) >= ref.shape[0]:
            return float("inf")
        worst = max(worst, float((ref.max(0).values - ref.gather(0, cls[None])[0]).max()))
    return worst


def control_gap(family, cfg: dict, params: Dict[str, torch.Tensor], volume: np.ndarray,
                patch, overlap, rows: int, device, quant: Callable) -> float:
    """``widest_gap`` of the classes that the reference computed with
    ``quant`` puts first: the precision control."""
    worst = 0.0
    low = core_logits(family, cfg, params, volume, patch, overlap, rows, device, quant)
    full = core_logits(family, cfg, params, volume, patch, overlap, rows, device)
    for (_, q), (_, ref) in zip(low, full):
        cls = q.argmax(0, keepdim=True)
        worst = max(worst, float((ref.max(0).values - ref.gather(0, cls)[0]).max()))
    return worst
