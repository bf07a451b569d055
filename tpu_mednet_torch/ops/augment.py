"""On-device augmentation, drawn from a ``torch.Generator``.

Counterpart of ``tpu_mednet/ops/augment.py``: the reference's
batchgenerators Compose (``examples/train_seg.py:82-86``: brightness
N(0, 0.3), gamma in (0.7, 1.3), contrast in (0.3, 1.7)) plus mirror flips,
voxel noise and the spatial transform (``spatial_3d``: elastic
deformation, rotation and isotropic scaling in one resample), run on the
device-resident batch inside the train step, in the JAX package's order.

Each transform is split into a draw (``draw_*``: its random parameters
from an explicit generator, on the generator's device) and an apply on
given parameters, so the same draws can be fed to both packages.  Inputs
are channels-first (N, C, X, Y, Z); ``mirror_axes`` keeps the JAX
package's numbering of the spatial axes (1, 2, 3 of (N, X, Y, Z, C)).

The spatial transform's default ``separable`` method computes the JAX
package's banded tent sum (``resample_axis``) as a two-tap gather along
each axis, with JAX's tap weights, rather than its 2 * band + 2 shifted
copies of the volume; ``exact`` is the eight-gather trilinear sample.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

SPATIAL_DIMS = (2, 3, 4)


def draw_brightness(n: int, c: int, generator: torch.Generator, mu: float = 0.0,
                    sigma: float = 0.3) -> torch.Tensor:
    """(N, C) additive offsets ~ N(mu, sigma), fp32."""
    return mu + sigma * torch.randn((n, c), generator=generator,
                                    device=generator.device)


def brightness(x: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """Per-sample, per-channel additive brightness offset."""
    return x + offsets.to(x.dtype).view(*offsets.shape, 1, 1, 1)


def _uniform(shape, generator: torch.Generator, lo: float, hi: float) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=generator.device)
    return lo + (hi - lo) * u


def draw_gamma(n: int, generator: torch.Generator,
               gamma_range: Tuple[float, float] = (0.7, 1.3)) -> torch.Tensor:
    """(N,) gamma exponents, uniform in ``gamma_range``, fp32."""
    return _uniform((n,), generator, *gamma_range)


def gamma(x: torch.Tensor, g: torch.Tensor, epsilon: float = 1e-7) -> torch.Tensor:
    """Per-sample gamma warp on the min-max-normalised intensity range."""
    g = g.to(x.dtype).view(-1, 1, 1, 1, 1)
    dims = tuple(range(1, x.dim()))
    mn = x.amin(dim=dims, keepdim=True)
    rng = x.amax(dim=dims, keepdim=True) - mn
    xn = (x - mn) / (rng + epsilon)
    return torch.pow(xn.clamp(epsilon, 1.0), g) * rng + mn


def draw_contrast(n: int, c: int, generator: torch.Generator,
                  contrast_range: Tuple[float, float] = (0.3, 1.7)) -> torch.Tensor:
    """(N, C) contrast factors, uniform in ``contrast_range``, fp32."""
    return _uniform((n, c), generator, *contrast_range)


def contrast(x: torch.Tensor, factors: torch.Tensor,
             preserve_range: bool = True) -> torch.Tensor:
    """``(x - m) * f + m`` per (sample, channel) about the channel's mean,
    clamped back to its [min, max] (batchgenerators' ``augment_contrast``
    defaults, as the reference composes it)."""
    f = factors.to(x.dtype).view(*factors.shape, 1, 1, 1)
    m = x.mean(dim=SPATIAL_DIMS, keepdim=True)
    y = (x - m) * f + m
    if preserve_range:
        y = torch.clamp(y, x.amin(dim=SPATIAL_DIMS, keepdim=True),
                        x.amax(dim=SPATIAL_DIMS, keepdim=True))
    return y


def draw_mirror(n: int, generator: torch.Generator, axes: Sequence[int] = (1, 2, 3),
                p: float = 0.5) -> torch.Tensor:
    """(len(axes), N) bool: flip sample i along axis k."""
    return torch.rand((len(axes), n), generator=generator, device=generator.device) < p


def mirror(x: torch.Tensor, flips: torch.Tensor, label: Optional[torch.Tensor] = None,
           axes: Sequence[int] = (1, 2, 3)):
    """Per-sample mirror flips along spatial axes, applied alike to the
    label where one is given (then ``(x, label)`` is returned)."""
    for ax, flip in zip(axes, flips):
        f = flip.view(-1, 1, 1, 1, 1)
        x = torch.where(f, x.flip(ax + 1), x)
        if label is not None:
            label = torch.where(f, label.flip(ax + 1), label)
    return x if label is None else (x, label)


def draw_noise(shape: Sequence[int], generator: torch.Generator) -> torch.Tensor:
    """Standard normal voxel noise of ``shape``, fp32."""
    return torch.randn(tuple(shape), generator=generator, device=generator.device)


def gaussian_noise(x: torch.Tensor, noise: torch.Tensor, sigma: float = 0.1) -> torch.Tensor:
    """Additive voxel-wise noise ``sigma * noise``."""
    return x + (sigma * noise).to(x.dtype)


# -- spatial transform (elastic + rotation + scaling) -------------------------

class SpatialDraws(NamedTuple):
    """One batch's spatial-transform parameters; None where that part is off."""

    apply: torch.Tensor                    # (N,) bool: transform sample i
    elastic: Optional[torch.Tensor] = None  # (N, g, g, g, 3) coarse displacements, voxels
    angles: Optional[torch.Tensor] = None   # (N, 3) radians
    scale: Optional[torch.Tensor] = None    # (N,)


def draw_spatial(n: int, generator: torch.Generator, elastic_sigma: float = 0.0,
                 elastic_grid: int = 4, rotate_deg: float = 0.0,
                 scale_range: Optional[Tuple[float, float]] = None,
                 p: float = 1.0) -> SpatialDraws:
    """The draws of ``spatial_3d`` for N samples, fp32: the per-sample
    apply bit (probability ``p``), a coarse ``elastic_grid``^3 field of
    N(0, ``elastic_sigma``) displacements, angles uniform in +-``rotate_deg``
    per axis and a scale uniform in ``scale_range``, each only where
    configured (``tpu_mednet/ops/augment.py:184-208, 373-375``)."""
    dev = generator.device
    apply = torch.rand((n,), generator=generator, device=dev) < p
    elastic = angles = scale = None
    if elastic_sigma:
        g = elastic_grid
        elastic = elastic_sigma * torch.randn((n, g, g, g, 3), generator=generator, device=dev)
    if rotate_deg:
        angles = _uniform((n, 3), generator, -rotate_deg, rotate_deg) * (math.pi / 180.0)
    if scale_range is not None:
        scale = _uniform((n,), generator, *scale_range)
    return SpatialDraws(apply, elastic, angles, scale)


def rotation_matrix(angles: torch.Tensor) -> torch.Tensor:
    """R = Rx(a) @ Ry(b) @ Rz(c) for ``angles`` (..., 3) in radians, (..., 3, 3)
    fp32 (batchgenerators' rotate_coords_3d composition,
    ``tpu_mednet/ops/augment.py:161-170``)."""
    ca, cb, cc = torch.cos(angles).unbind(-1)
    sa, sb, sc = torch.sin(angles).unbind(-1)
    one, zero = torch.ones_like(ca), torch.zeros_like(ca)
    rx = torch.stack([one, zero, zero, zero, ca, -sa, zero, sa, ca], -1)
    ry = torch.stack([cb, zero, sb, zero, one, zero, -sb, zero, cb], -1)
    rz = torch.stack([cc, -sc, zero, sc, cc, zero, zero, zero, one], -1)
    shape = (*angles.shape[:-1], 3, 3)
    return _matmul3(_matmul3(rx.view(shape), ry.view(shape)), rz.view(shape))


def _matmul3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) @ (..., 3, 3) as fp32 sums of products in k order, the
    same on every device (no TF32, no library's blocking)."""
    return sum(a[..., :, k, None] * b[..., None, k, :] for k in range(3))


def _grid(shape: Sequence[int], device) -> Tuple[torch.Tensor, ...]:
    """The voxel coordinates along each axis, fp32, each (1, X, Y, Z)-broadcastable."""
    out = []
    for axis, s in enumerate(shape):
        view = [1, 1, 1, 1]
        view[axis + 1] = s
        out.append(torch.arange(s, dtype=torch.float32, device=device).view(view))
    return tuple(out)


def sample_coords(shape: Sequence[int], draws: SpatialDraws) -> torch.Tensor:
    """Deformed sample positions (N, 3, X, Y, Z) fp32 for each sample
    (``tpu_mednet/ops/augment.py:172-208``): ``rel = (base - centre) *
    scale``, then ``rel @ R.T``, plus the centre, plus the coarse elastic
    field upsampled trilinearly with half-pixel centres (as
    ``jax.image.resize(method='linear')``)."""
    n, dev = draws.apply.shape[0], draws.apply.device
    base = _grid(shape, dev)
    coords = [b.expand(n, *shape) for b in base]
    if draws.angles is not None or draws.scale is not None:
        centre = [(s - 1.0) / 2.0 for s in shape]
        rel = [b - c for b, c in zip(base, centre)]
        if draws.scale is not None:
            sc = draws.scale.view(n, 1, 1, 1)
            rel = [r * sc for r in rel]
        if draws.angles is not None:
            rot = rotation_matrix(draws.angles).view(n, 3, 3, 1, 1, 1)
            rel = [rel[0] * rot[:, j, 0] + rel[1] * rot[:, j, 1] + rel[2] * rot[:, j, 2]
                   for j in range(3)]
        coords = [(r + c).expand(n, *shape) for r, c in zip(rel, centre)]
    coords = torch.stack(coords, 1)
    if draws.elastic is not None:
        disp = F.interpolate(draws.elastic.permute(0, 4, 1, 2, 3), size=tuple(shape),
                             mode="trilinear", align_corners=False)
        coords = coords + disp
    return coords


def axis_band(shape: Sequence[int], axis: int, elastic_sigma: float, rotate_deg: float,
              scale_range) -> int:
    """Static bound on |displacement| along ``axis`` in voxels: 2.5 elastic
    sigmas plus the affine part's worst over the patch corners at the
    extreme scales and angles (``tpu_mednet/ops/augment.py:211-247``)."""
    band = 2.5 * float(elastic_sigma) if elastic_sigma else 0.0
    if rotate_deg or scale_range is not None:
        half = (np.asarray(shape, np.float64) - 1.0) / 2.0
        # R * s - I is linear in s at fixed angles: its worst over the scale
        # interval is at an end, so both ends are checked
        scales = ((float(scale_range[0]), float(scale_range[1]))
                  if scale_range is not None else (1.0,))
        a = np.deg2rad(float(rotate_deg))
        worst = 0.0
        for s in scales:
            for sx in (-a, a):
                for sy in (-a, a):
                    for sz in (-a, a):
                        ca, cb, cc = np.cos([sx, sy, sz])
                        sa, sb, sc2 = np.sin([sx, sy, sz])
                        rx = np.array([[1, 0, 0], [0, ca, -sa], [0, sa, ca]])
                        ry = np.array([[cb, 0, sb], [0, 1, 0], [-sb, 0, cb]])
                        rz = np.array([[cc, -sc2, 0], [sc2, cc, 0], [0, 0, 1]])
                        m = (rx @ ry @ rz) * s - np.eye(3)
                        worst = max(worst, float(np.abs(m[axis]) @ half))
        band += worst
    return int(np.ceil(band)) + 1


def _take(vol: torch.Tensor, dim: int, idx: torch.Tensor) -> torch.Tensor:
    """``vol`` (N, C, X, Y, Z) gathered along ``dim`` at int64 ``idx``
    (N, 1, X, Y, Z), the same index for every channel."""
    return torch.gather(vol, dim, idx.expand(vol.shape[0], vol.shape[1], *idx.shape[2:]))


def resample_axis(vol: torch.Tensor, offset: torch.Tensor, axis: int,
                  nearest: bool = False) -> torch.Tensor:
    """1D resample of ``vol`` (N, C, X, Y, Z) along spatial ``axis`` (0..2):
    ``out[p] = vol_interp[p_axis + offset[p]]``, ``offset`` (N, 1, X, Y, Z)
    fp32, with clamp-to-edge borders (``tpu_mednet/ops/augment.py:250-296``).

    The JAX package sums tent-weighted shifted copies over a band; the
    two taps it weights non-zero are gathered here, each weighted as JAX
    weights it, ``max(0, 1 - |src - tap|)`` in fp32 cast to the volume's
    dtype, and added lower tap first.  Nearest takes the tap ``idx`` with
    ``-0.5 < src - idx <= 0.5`` (rounding half down), which is exact."""
    s = vol.shape[axis + 2]
    base = _grid(vol.shape[2:], vol.device)[axis].unsqueeze(0)
    src = (base + offset).clamp(0.0, float(s - 1))
    lo = torch.floor(src)
    if nearest:
        idx = lo + ((src - lo) > 0.5)
        return _take(vol, axis + 2, idx.long())
    w_lo = (1.0 - (src - lo).abs()).clamp_min(0.0).to(vol.dtype)
    w_hi = (1.0 - (src - (lo + 1.0)).abs()).clamp_min(0.0).to(vol.dtype)
    lo = lo.long()
    hi = (lo + 1).clamp_max(s - 1)
    return w_lo * _take(vol, axis + 2, lo) + w_hi * _take(vol, axis + 2, hi)


def _separable_warp(vol: torch.Tensor, disp: torch.Tensor, bands: Sequence[int],
                    nearest: bool) -> torch.Tensor:
    """x, then y, then z 1D resamples by the displacement ``disp``
    (N, 3, X, Y, Z): exact for a displacement along one axis, O(theta^2)
    off for composed rotations (``tpu_mednet/ops/augment.py:299-312``)."""
    out = vol
    for axis in range(3):
        if bands[axis] > 0:
            out = resample_axis(out, disp[:, axis:axis + 1], axis, nearest=nearest)
    return out


def _flat_index(shape: Sequence[int], ix: torch.Tensor, iy: torch.Tensor,
                iz: torch.Tensor) -> torch.Tensor:
    return ((ix * shape[1] + iy) * shape[2] + iz).flatten(1).unsqueeze(1)


def _gather_points(vol: torch.Tensor, index: torch.Tensor, out_shape) -> torch.Tensor:
    n, c = vol.shape[:2]
    flat = torch.gather(vol.reshape(n, c, -1), 2, index.expand(n, c, index.shape[-1]))
    return flat.view(n, c, *out_shape)


def trilinear_sample(vol: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """``vol`` (N, C, X, Y, Z) at fp32 ``coords`` (N, 3, X', Y', Z'):
    trilinear with edge clamping, eight gathers and JAX's lerp order in the
    volume's dtype (``tpu_mednet/ops/augment.py:114-146``)."""
    shape = vol.shape[2:]
    c = torch.stack([coords[:, a].clamp(0.0, float(shape[a] - 1)) for a in range(3)], 1)
    lo = torch.floor(c)
    t = (c - lo).to(vol.dtype)
    lo = lo.long()
    hi = torch.stack([(lo[:, a] + 1).clamp_max(shape[a] - 1) for a in range(3)], 1)
    out_shape = coords.shape[2:]

    def at(x, y, z):
        return _gather_points(vol, _flat_index(shape, x[:, 0], y[:, 1], z[:, 2]), out_shape)

    tx, ty, tz = t[:, 0:1], t[:, 1:2], t[:, 2:3]
    c00 = at(lo, lo, lo) * (1 - tx) + at(hi, lo, lo) * tx
    c10 = at(lo, hi, lo) * (1 - tx) + at(hi, hi, lo) * tx
    c01 = at(lo, lo, hi) * (1 - tx) + at(hi, lo, hi) * tx
    c11 = at(lo, hi, hi) * (1 - tx) + at(hi, hi, hi) * tx
    c0 = c00 * (1 - ty) + c10 * ty
    c1 = c01 * (1 - ty) + c11 * ty
    return c0 * (1 - tz) + c1 * tz


def nearest_sample(vol: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """``vol`` (N, C, X, Y, Z) at the voxels nearest ``coords`` (N, 3, X', Y',
    Z'), rounding half to even, clamped: label values stay in-set
    (``tpu_mednet/ops/augment.py:149-158``)."""
    shape = vol.shape[2:]
    idx = [torch.round(coords[:, a]).clamp(0.0, float(shape[a] - 1)).long() for a in range(3)]
    return _gather_points(vol, _flat_index(shape, *idx), coords.shape[2:])


def _warp_label(lbl: torch.Tensor, warp_linear: Callable, warp_nearest: Callable,
                trilinear_channels: int) -> torch.Tensor:
    """The leading ``trilinear_channels`` label channels (landmark heatmaps)
    warp linearly in fp32, rounded back for integer dtypes; the rest (the
    class map) nearest, so class values stay in-set
    (``tpu_mednet/ops/augment.py:315-334``)."""
    c = lbl.shape[1]
    k = min(trilinear_channels, c)
    if k <= 0:
        return warp_nearest(lbl)
    hm = warp_linear(lbl[:, :k].float())
    if not lbl.dtype.is_floating_point:
        hm = torch.round(hm)
    hm = hm.to(lbl.dtype)
    if k == c:
        return hm
    return torch.cat([hm, warp_nearest(lbl[:, k:])], dim=1)


def spatial_3d(x: torch.Tensor, draws: SpatialDraws, label: Optional[torch.Tensor] = None,
               elastic_sigma: float = 0.0, rotate_deg: float = 0.0,
               scale_range: Optional[Tuple[float, float]] = None,
               method: str = "separable", label_trilinear_channels: int = 0):
    """Per-sample spatial transform of (N, C, X, Y, Z) batches from
    ``draws`` (``draw_spatial`` of the same elastic, rotation and scale
    settings): the image resampled linearly, the label nearest but for its
    leading ``label_trilinear_channels`` (``_warp_label``), clamp-to-edge
    borders; samples whose apply bit is off pass unchanged
    (``tpu_mednet/ops/augment.py:337-421``).

    ``method='separable'`` (default) runs three 1D passes along x, y and z,
    the displacement clipped to each axis's ``axis_band``;
    ``method='exact'`` one trilinear sample at the deformed positions.
    Returns ``y`` or, with a ``label``, ``(y, label)``."""
    if method not in ("separable", "exact"):
        raise ValueError(f"unknown spatial method {method!r}")
    shape = tuple(x.shape[2:])
    coords = sample_coords(shape, draws)
    if method == "separable":
        bands = tuple(axis_band(shape, ax, elastic_sigma, rotate_deg, scale_range)
                      if (elastic_sigma or rotate_deg or scale_range is not None) else 0
                      for ax in range(3))
        base = _grid(shape, x.device)
        disp = torch.cat([(coords[:, a:a + 1] - base[a]).clamp(-float(bands[a]), float(bands[a]))
                          for a in range(3)], 1)
        warp_linear = lambda t: _separable_warp(t, disp, bands, nearest=False)
        warp_nearest = lambda t: _separable_warp(t, disp, bands, nearest=True)
    else:
        warp_linear = lambda t: trilinear_sample(t, coords)
        warp_nearest = lambda t: nearest_sample(t, coords)
    do = draws.apply.view(-1, 1, 1, 1, 1)
    y = torch.where(do, warp_linear(x), x)
    if label is None:
        return y
    lwarp = _warp_label(label, warp_linear, warp_nearest, label_trilinear_channels)
    return y, torch.where(do, lwarp, label)


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    """Which augmentations the train step applies.

    Defaults reproduce the reference Compose (train_seg.py:84-86); mirror,
    noise and the spatial transform are off by default.  The spatial
    transform (elastic coarse-grid sigma in voxels, the largest rotation in
    degrees per axis, an isotropic scale range) applies per sample with
    ``spatial_prob``; ``label_trilinear_channels`` leading label channels
    (landmark heatmaps, set by the Trainer from ``task.num_heatmaps``) warp
    linearly instead of nearest.
    """

    brightness_mu: float = 0.0
    brightness_sigma: float = 0.3
    gamma_range: Optional[Tuple[float, float]] = (0.7, 1.3)
    contrast_range: Optional[Tuple[float, float]] = (0.3, 1.7)
    mirror_axes: Tuple[int, ...] = ()
    noise_sigma: float = 0.0
    elastic_sigma: float = 0.0
    elastic_grid: int = 4
    rotate_deg: float = 0.0
    scale_range: Optional[Tuple[float, float]] = None
    spatial_prob: float = 1.0
    label_trilinear_channels: int = 0

    def wants_spatial(self) -> bool:
        return bool(self.elastic_sigma or self.rotate_deg or self.scale_range is not None)


class AugmentDraws(NamedTuple):
    """One batch's random parameters; None where the transform is off."""

    spatial: Optional[SpatialDraws] = None
    brightness: Optional[torch.Tensor] = None   # (N, C)
    gamma: Optional[torch.Tensor] = None        # (N,)
    contrast: Optional[torch.Tensor] = None     # (N, C)
    mirror: Optional[torch.Tensor] = None       # (len(mirror_axes), N) bool
    noise: Optional[torch.Tensor] = None        # x's shape


def draw_augmentations(config: AugmentConfig, shape: Sequence[int],
                       generator: torch.Generator) -> AugmentDraws:
    """The draws of every configured transform for a batch of ``shape``
    (N, C, X, Y, Z), in the order they are applied (with the spatial
    transform off, the generator's stream is what it was without it)."""
    n, c = shape[:2]
    return AugmentDraws(
        spatial=(draw_spatial(n, generator, config.elastic_sigma, config.elastic_grid,
                              config.rotate_deg, config.scale_range, config.spatial_prob)
                 if config.wants_spatial() else None),
        brightness=(draw_brightness(n, c, generator, config.brightness_mu,
                                    config.brightness_sigma)
                    if config.brightness_sigma > 0 else None),
        gamma=draw_gamma(n, generator, config.gamma_range) if config.gamma_range else None,
        contrast=(draw_contrast(n, c, generator, config.contrast_range)
                  if config.contrast_range else None),
        mirror=draw_mirror(n, generator, config.mirror_axes) if config.mirror_axes else None,
        noise=draw_noise(shape, generator) if config.noise_sigma > 0 else None,
    )


def draw_rows(draws: AugmentDraws, rows: slice) -> AugmentDraws:
    """The draws of ``rows`` of the batch they were drawn for: a data-
    parallel rank draws for the global batch, as one process would, and
    applies its own rows' share."""
    def cut(t, dim=0):
        return None if t is None else t.narrow(dim, rows.start, rows.stop - rows.start)

    spatial = draws.spatial
    if spatial is not None:
        spatial = SpatialDraws(*(cut(t) for t in spatial))
    return AugmentDraws(spatial=spatial, brightness=cut(draws.brightness),
                        gamma=cut(draws.gamma), contrast=cut(draws.contrast),
                        mirror=cut(draws.mirror, 1), noise=cut(draws.noise))


def apply_augmentations(x: torch.Tensor, config: AugmentConfig,
                        generator: Optional[torch.Generator] = None,
                        label: Optional[torch.Tensor] = None,
                        draws: Optional[AugmentDraws] = None):
    """spatial -> brightness -> gamma -> contrast -> mirror -> noise, the JAX
    package's order, on draws from ``generator`` (or the given ``draws``).
    With a ``label``, the spatial transform and mirror flips move it with
    the image and ``(x, label)`` is returned."""
    if draws is None:
        draws = draw_augmentations(config, x.shape, generator)
    if draws.spatial is not None:
        kw = dict(elastic_sigma=config.elastic_sigma, rotate_deg=config.rotate_deg,
                  scale_range=config.scale_range)
        if label is not None:
            x, label = spatial_3d(x, draws.spatial, label=label,
                                  label_trilinear_channels=config.label_trilinear_channels,
                                  **kw)
        else:
            x = spatial_3d(x, draws.spatial, **kw)
    if draws.brightness is not None:
        x = brightness(x, draws.brightness)
    if draws.gamma is not None:
        x = gamma(x, draws.gamma)
    if draws.contrast is not None:
        x = contrast(x, draws.contrast)
    if draws.mirror is not None:
        if label is not None:
            x, label = mirror(x, draws.mirror, label, config.mirror_axes)
        else:
            x = mirror(x, draws.mirror, axes=config.mirror_axes)
    if draws.noise is not None:
        x = gaussian_noise(x, draws.noise, config.noise_sigma)
    return x if label is None else (x, label)
