"""Whole-volume inference with the volume's X axis split over the space axis.

Counterpart of ``tpu_mednet/inference/spatial.py``: for a volume whose
activations exceed one card's memory, the alternative to patch tiling is
splitting its X axis over the ranks of a data row (``parallel/mesh.py``)
and running the U-Net once over the whole volume, boundary rows exchanged
between ranks instead of recomputed in overlapping tiles.  Every rank of
the row calls ``predict_volume_spatial`` with the same volume; each runs
its slab, and every rank gets the whole result.

Two modes, as in the JAX package:

- ``auto``: the layer-wise path (``models/blocks.py`` on a ``SpaceAxis``),
  the unsplit function, as GSPMD's partitioning gives it: every
  convolution exchanges its halo, GroupNorm's statistics are the volume's,
  and a mirror of the split axis moves rows between ranks
  (``parallel.halo.mirror_rows``);
- ``explicit``: one exchange of ``halo`` rows, a forward of each padded
  slab on its own (its GroupNorm statistics are the padded slab's, as in
  JAX's ``shard_map``), then the crop (``spatially_sharded_apply``).
"""

from __future__ import annotations

from itertools import chain, combinations
from typing import Optional

import numpy as np
import torch

from tpu_mednet_torch.inference.common import (check_model_device, postprocess_activations,
                                               split_activations, tta_split_activations)
from tpu_mednet_torch.models.blocks import space_axis
from tpu_mednet_torch.parallel.halo import (SpaceAxis, gather_volume, mirror_rows,
                                            spatially_sharded_apply)
from tpu_mednet_torch.parallel.mesh import DataMesh, slab_plan

CL3D = torch.channels_last_3d


def receptive_halo(num_levels: int, convs_per_block: int = 3,
                   kernel_radius: int = 1) -> int:
    """Upper bound on the one-sided receptive-field reach of the U-Net.

    Each level runs ~``convs_per_block`` 3^3 convs at stride 2^level (both
    encoder and decoder sides), so reach ≈ sum_l 2 * convs * radius * 2^l.
    """
    reach = 0
    for level in range(num_levels):
        reach += 2 * convs_per_block * kernel_radius * (2**level)
    return reach


def _auto_activations(task, volume: torch.Tensor, mesh: DataMesh, plan, flips):
    """``tta_split_activations`` of the whole volume, on this rank's slab:
    the input mirrored on the host, the activations of a subset that
    mirrors X moved back to their rows' ranks."""
    rows = plan.slab(mesh.space_index)
    subsets = list(chain.from_iterable(combinations(flips, r)
                                       for r in range(len(flips) + 1)))
    acc = None
    for subset in subsets:
        dims = [a + 2 for a in subset]
        x = torch.flip(volume, dims) if dims else volume
        act = split_activations(task, x[:, :, rows].to(mesh.device).contiguous(
            memory_format=CL3D))
        local = [d for d in dims if d != 2]
        act = torch.flip(act, local) if local else act
        if 2 in dims:
            act = mirror_rows(act.contiguous(memory_format=CL3D), mesh, plan.lengths)
        acc = act if acc is None else acc + act
    return acc / len(subsets)


def predict_volume_spatial(task, volume: np.ndarray, mesh: DataMesh, mode: str = "auto",
                           halo: Optional[int] = None, tta_flips=()) -> np.ndarray:
    """Run the task's forward and postprocess over one whole volume, split
    along X over ``mesh``'s space axis; every rank of the data row calls it
    with the same ``volume``, the task's model on ``mesh.device``.

    ``volume`` is (C, X, Y, Z) on the host (the reference's storage
    layout).  X is padded with zeros to a multiple of ``lcm(n_space,
    pool)`` as the JAX package pads it (the padding enters GroupNorm's
    statistics, so the result is that of this padded volume), then split
    by ``slab_plan`` into whole pooling windows (``auto``), or evenly, as
    JAX's shards are (``explicit``, whose slabs run on their own).
    Returns the postprocessed (out_C, X, Y, Z) uint8 volume on every rank
    of the row.

    ``tta_flips`` (spatial axes 0..2) runs mirror test-time augmentation
    over the whole volume.  Under ``mode='auto'`` a flip of the split X
    axis moves rows between ranks; ``mode='explicit'`` applies the forward
    per slab, so mirroring the split axis (0) is refused, as in JAX.
    """
    model = task.model
    tta_flips = tuple(tta_flips)
    if mode == "explicit" and 0 in tta_flips:
        raise ValueError(
            "explicit halo mode cannot mirror the spatially-sharded X axis "
            "(axis 0); use tta axes 1/2 there, or mode='auto'"
        )
    if mode not in ("auto", "explicit"):
        raise ValueError(f"mode must be 'auto' or 'explicit', got {mode!r}")
    check_model_device(task, mesh.device)
    n_space = mesh.n_space
    x = torch.from_numpy(np.asarray(volume, dtype=np.float32))[None]  # (1, C, X, Y, Z)

    pool = 2 ** (len(model.config.feature_maps) - 1)
    quantum = int(np.lcm(n_space, pool))
    size_x = x.shape[2]
    pad_x = (-size_x) % quantum
    if pad_x:
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad_x))
    plan = slab_plan(x.shape[2], n_space, pool if mode == "auto" else 1)
    model.eval()
    with torch.inference_mode():
        if mode == "auto":
            with space_axis(model, SpaceAxis(mesh, plan) if mesh.spatial else None):
                if tta_flips:
                    out = postprocess_activations(
                        task, _auto_activations(task, x, mesh, plan, tta_flips))
                else:
                    slab = x[:, :, plan.slab(mesh.space_index)].to(mesh.device)
                    out = task.predict_postprocess(model(
                        slab.to(model.config.dtype).contiguous(memory_format=CL3D)))
        else:
            h = halo if halo is not None else receptive_halo(len(model.config.feature_maps))
            # halo slabs must survive the pooling pyramid: round up to pool
            h = int(-(-h // pool) * pool)

            def fwd(v):
                if tta_flips:
                    return postprocess_activations(task, tta_split_activations(task, v,
                                                                               tta_flips))
                return task.predict_postprocess(model(v.to(model.config.dtype)))

            sharded = spatially_sharded_apply(fwd, mesh, halo=h, lengths=plan.lengths)
            slab = x[:, :, plan.slab(mesh.space_index)].to(mesh.device)
            out = sharded(slab.contiguous(memory_format=CL3D))
        out = gather_volume(out.contiguous(memory_format=CL3D), mesh, plan.lengths)
    out = out[0].cpu().numpy()
    return out[:, :size_x] if pad_x else out
