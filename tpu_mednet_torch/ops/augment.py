"""On-device intensity and mirror augmentation, drawn from a ``torch.Generator``.

Counterpart of ``tpu_mednet/ops/augment.py:31-108, 423-497``: the
reference's batchgenerators Compose (``examples/train_seg.py:82-86``:
brightness N(0, 0.3), gamma in (0.7, 1.3), contrast in (0.3, 1.7)) plus
mirror flips and voxel noise, run on the device-resident batch inside the
train step, in the JAX package's order.

Each transform is split into a draw (``draw_*``: its random parameters
from an explicit generator, on the generator's device) and an apply on
given parameters, so the same draws can be fed to both packages.  Inputs
are channels-first (N, C, X, Y, Z); ``mirror_axes`` keeps the JAX
package's numbering of the spatial axes (1, 2, 3 of (N, X, Y, Z, C)).
The spatial transform (``spatial_3d``: elastic, rotation, scaling) is not
ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

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


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    """Which augmentations the train step applies.

    Defaults reproduce the reference Compose (train_seg.py:84-86); mirror
    and noise are off by default.  A config that sets the JAX package's
    spatial fields is refused until ``spatial_3d`` is ported.
    """

    brightness_mu: float = 0.0
    brightness_sigma: float = 0.3
    gamma_range: Optional[Tuple[float, float]] = (0.7, 1.3)
    contrast_range: Optional[Tuple[float, float]] = (0.3, 1.7)
    mirror_axes: Tuple[int, ...] = ()
    noise_sigma: float = 0.0
    elastic_sigma: float = 0.0
    rotate_deg: float = 0.0
    scale_range: Optional[Tuple[float, float]] = None

    def __post_init__(self):
        self.wants_spatial()

    def wants_spatial(self) -> bool:
        """False; raises where the spatial transform is asked for."""
        if self.elastic_sigma or self.rotate_deg or self.scale_range is not None:
            raise NotImplementedError("spatial_3d (elastic, rotation, scaling) is "
                                      "not ported yet")
        return False


class AugmentDraws(NamedTuple):
    """One batch's random parameters; None where the transform is off."""

    brightness: Optional[torch.Tensor] = None   # (N, C)
    gamma: Optional[torch.Tensor] = None        # (N,)
    contrast: Optional[torch.Tensor] = None     # (N, C)
    mirror: Optional[torch.Tensor] = None       # (len(mirror_axes), N) bool
    noise: Optional[torch.Tensor] = None        # x's shape


def draw_augmentations(config: AugmentConfig, shape: Sequence[int],
                       generator: torch.Generator) -> AugmentDraws:
    """The draws of every configured transform for a batch of ``shape``
    (N, C, X, Y, Z), in the order they are applied."""
    n, c = shape[:2]
    return AugmentDraws(
        brightness=(draw_brightness(n, c, generator, config.brightness_mu,
                                    config.brightness_sigma)
                    if config.brightness_sigma > 0 else None),
        gamma=draw_gamma(n, generator, config.gamma_range) if config.gamma_range else None,
        contrast=(draw_contrast(n, c, generator, config.contrast_range)
                  if config.contrast_range else None),
        mirror=draw_mirror(n, generator, config.mirror_axes) if config.mirror_axes else None,
        noise=draw_noise(shape, generator) if config.noise_sigma > 0 else None,
    )


def apply_augmentations(x: torch.Tensor, config: AugmentConfig,
                        generator: Optional[torch.Generator] = None,
                        label: Optional[torch.Tensor] = None,
                        draws: Optional[AugmentDraws] = None):
    """brightness -> gamma -> contrast -> mirror -> noise, the JAX package's
    order, on draws from ``generator`` (or the given ``draws``).  With a
    ``label``, mirror flips move it with the image and ``(x, label)`` is
    returned."""
    if draws is None:
        draws = draw_augmentations(config, x.shape, generator)
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
