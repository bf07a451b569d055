"""Seeded inputs: weights, training subjects and the serving pool.

Everything is drawn on the device from ``torch.Generator``s seeded by the
run's seed, in a few large calls, and the volumes are brought to the host,
where the program reads them as a user's data.  One seed gives the same
inputs on every run; the reference is handed the same host arrays and
draws the same weights again.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

# sub-seeds of a run's seed, one per stream of draws
STREAMS = {"weights": 0, "data": 1, "sampler": 2, "augment": 3, "order": 4, "sample": 5}


def sub_seed(seed: int, stream: str) -> int:
    return (int(seed) * len(STREAMS) + STREAMS[stream]) % 2 ** 62


def seeds(seed: int) -> Dict[str, int]:
    return {k: sub_seed(seed, k) for k in STREAMS}


def weights(family, cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The cell's fp32 parameters, keyed by the published state-dict names:
    the family's split of one flat U[0, 1) draw."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "weights"))
    u = torch.rand(family.param_count(cfg), generator=gen, device=device)
    return family.init_from_uniform(cfg, u)


def _noise(gen, shape, device) -> torch.Tensor:
    return 0.5 * torch.randn(tuple(shape), generator=gen, device=device)


def training_subjects(traffic: dict, n_classes: int, seed: int, device) -> dict:
    """Host stores of the subjects: ``images`` (1, X, Y, Z) float32,
    ``labels`` (1, X, Y, Z) uint8 class maps with one box of each
    foreground class (an eighth to a quarter of the extent a side),
    brighter by 0.5 per class, in N(0, 0.5) noise, and
    with ``landmarks_per_subject``, ``landmarks`` (L, 3) float32 voxel
    positions at least an eighth of the extent inside the volume."""
    rng = np.random.default_rng(sub_seed(seed, "data"))
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "data"))
    n_ldmk = int(traffic.get("landmarks_per_subject", 0))
    store = {"images": {}, "labels": {}}
    if n_ldmk:
        store["landmarks"] = {}
    for i, shape in enumerate(traffic["subjects"]):
        key = f"s{i}"
        shape = np.asarray(shape, dtype=np.int64)
        label = torch.zeros(tuple(shape), dtype=torch.uint8, device=device)
        for c in range(1, n_classes):
            size = rng.integers(shape // 8, shape // 4 + 1)
            lo = rng.integers(0, shape - size + 1)
            label[lo[0]:lo[0] + size[0], lo[1]:lo[1] + size[1], lo[2]:lo[2] + size[2]] = c
        image = _noise(gen, shape, device) + 0.5 * label.float()
        store["images"][key] = image[None].cpu().numpy()
        store["labels"][key] = label[None].cpu().numpy()
        if n_ldmk:
            where = rng.uniform(shape // 8, shape - shape // 8, size=(n_ldmk, 3))
            store["landmarks"][key] = where.astype(np.float32)
    return store


def serving_pool(traffic: dict, seed: int, device) -> Dict[str, np.ndarray]:
    """Host (1, X, Y, Z) f16 volumes of the pool's extents: N(0, 0.5) noise
    with three boxes of an eighth to a third of the extent a side, brighter by 1, 2 and 3."""
    rng = np.random.default_rng(sub_seed(seed, "data"))
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "data"))
    pool = {}
    for i, shape in enumerate(traffic["pool"]):
        shape = np.asarray(shape, dtype=np.int64)
        vol = _noise(gen, shape, device)
        for level in (1.0, 2.0, 3.0):
            size = rng.integers(shape // 8, shape // 3 + 1)
            lo = rng.integers(0, shape - size + 1)
            vol[lo[0]:lo[0] + size[0], lo[1]:lo[1] + size[1], lo[2]:lo[2] + size[2]] += level
        pool[f"v{i:02d}"] = vol.to(torch.float16)[None].cpu().numpy()
    return pool


def extent_tiles(shape: Sequence[int], patch: Sequence[int], overlap: Sequence[int]) -> int:
    """Tiles of the reference grid over a volume of ``shape``."""
    n = 1
    for s, p, o in zip(shape, patch, overlap):
        n *= -(-int(s) // (int(p) - 2 * int(o)))
    return n
