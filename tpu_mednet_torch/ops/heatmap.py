"""Gaussian landmark heatmaps, rendered from coordinates on the tensor's device.

Counterpart of ``tpu_mednet/ops/heatmap.py:24-98`` in the port's
channels-first layout: coordinates stay (L, 3) voxel positions (x, y, z),
and heatmaps are (L, X, Y, Z), or (N, L, X, Y, Z) batched.  The amplitude
convention is the reference's 0..255 (its predict clips heatmaps to
[0, 255]).  Plain PyTorch: the JAX package computes these in jnp too,
outside any Pallas kernel.
"""

from __future__ import annotations

from typing import Sequence, Union

import torch

Sigma = Union[float, Sequence[float], torch.Tensor]


def batched_gaussian_heatmaps(coords: torch.Tensor, shape: Sequence[int], sigma: Sigma,
                              amplitude: float = 255.0,
                              dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(N, L, 3) voxel coordinates -> (N, L, X, Y, Z) Gaussian heatmaps.

    Coordinates may be fractional and may lie outside the volume (the tail
    still renders, as a crop of a stored heatmap would); a coordinate with
    any component below -1000 is a missing-landmark sentinel and renders
    all zeros.  ``sigma`` is a scalar or per-landmark (L,) standard
    deviation in voxels.  Separable: three small exps and their outer
    product, in the JAX package's order of operations.
    """
    coords = torch.as_tensor(coords, dtype=torch.float32)
    if coords.dim() != 3 or coords.shape[-1] != 3:
        raise ValueError(f"coords must be (N, L, 3), got {tuple(coords.shape)}")
    dev = coords.device
    sigma = torch.broadcast_to(torch.as_tensor(sigma, dtype=torch.float32, device=dev),
                               (coords.shape[1],))
    inv2s2 = 1.0 / (2.0 * sigma**2)  # (L,)
    ex, ey, ez = (
        torch.exp(-((torch.arange(size, dtype=torch.float32, device=dev)
                     - coords[..., axis, None]) ** 2) * inv2s2[:, None])
        for axis, size in enumerate(shape))  # each (N, L, size)
    hm = (ex[..., :, None, None] * ey[..., None, :, None] * ez[..., None, None, :]) * amplitude
    valid = (coords > -1000.0).all(dim=-1)  # (N, L)
    hm = torch.where(valid[..., None, None, None], hm, 0.0)
    return hm.to(dtype)


def gaussian_heatmap(coords: torch.Tensor, shape: Sequence[int], sigma: Sigma,
                     amplitude: float = 255.0,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(L, 3) voxel coordinates -> (L, X, Y, Z) heatmaps (see
    ``batched_gaussian_heatmaps``)."""
    coords = torch.as_tensor(coords, dtype=torch.float32)
    if coords.dim() != 2 or coords.shape[-1] != 3:
        raise ValueError(f"coords must be (L, 3), got {tuple(coords.shape)}")
    return batched_gaussian_heatmaps(coords[None], shape, sigma, amplitude, dtype)[0]


def heatmap_argmax_coords(heatmaps: torch.Tensor) -> torch.Tensor:
    """(..., L, X, Y, Z) heatmaps -> (..., L, 3) int64 peak voxel coordinates
    (the first maximum in x, y, z order, as ``jnp.argmax``)."""
    *lead, sx, sy, sz = heatmaps.shape
    idx = heatmaps.reshape(*lead, sx * sy * sz).argmax(dim=-1)
    return torch.stack([idx // (sy * sz), (idx // sz) % sy, idx % sz], dim=-1)
