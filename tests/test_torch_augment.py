"""The port's augmentation against the JAX package's, given the same draws.

The draws are made with the JAX key splits ``apply_augmentations`` uses
(``tpu_mednet/ops/augment.py:465``, then brightness ``:34``, gamma ``:42``,
contrast ``:68``, mirror ``:92-96`` and noise ``:108``) and handed to the
port's apply; image and label must then agree at fp32 atol 1e-6 (the same
elementwise formulas; the per-channel means and ``pow`` are computed by
other libraries and may differ in the last bits).  The port's own draws
come from a ``torch.Generator`` and are reproducible by seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_mednet.ops import augment as JA
from tpu_mednet_torch.ops import augment as A

SHAPE = (3, 6, 5, 4, 2)  # (N, X, Y, Z, C)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(0.5, 1.0, size=SHAPE).astype(np.float32)
    label = rng.integers(0, 3, size=(*SHAPE[:4], 1)).astype(np.uint8)
    return x, label


def _jax_draws(key, cfg, shape):
    """The JAX package's draws for ``cfg``, as the port's ``AugmentDraws``."""
    n, c = shape[0], shape[-1]
    k_b, k_g, k_c, k_m, k_n, _ = jax.random.split(key, 6)
    offs = cfg.brightness_mu + cfg.brightness_sigma * jax.random.normal(
        k_b, (n, 1, 1, 1, c), dtype=jnp.float32)
    g = jax.random.uniform(k_g, (n, 1, 1, 1, 1), dtype=jnp.float32,
                           minval=cfg.gamma_range[0], maxval=cfg.gamma_range[1])
    f = jax.random.uniform(k_c, (n, 1, 1, 1, c), dtype=jnp.float32,
                           minval=cfg.contrast_range[0], maxval=cfg.contrast_range[1])
    flips = [jax.random.bernoulli(k, 0.5, (n, 1, 1, 1, 1))
             for k in jax.random.split(k_m, len(cfg.mirror_axes))]
    noise = jax.random.normal(k_n, shape, dtype=jnp.float32)
    t = lambda a: torch.from_numpy(np.asarray(a).copy())
    return A.AugmentDraws(
        brightness=t(offs).view(n, c), gamma=t(g).view(n), contrast=t(f).view(n, c),
        mirror=torch.stack([t(fl).view(n) for fl in flips]) if cfg.mirror_axes else None,
        noise=t(noise).permute(0, 4, 1, 2, 3) if cfg.noise_sigma > 0 else None)


CONFIGS = {
    "reference-compose": dict(),
    "bench-mirror": dict(mirror_axes=(1, 2, 3)),
    "mirror-noise": dict(mirror_axes=(2, 3), noise_sigma=0.1),
}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_apply_matches_jax_given_the_same_draws(name, seed):
    kw = CONFIGS[name]
    jcfg, cfg = JA.AugmentConfig(**kw), A.AugmentConfig(**kw)
    x, label = _batch(seed)
    key = jax.random.PRNGKey(seed)
    y_ref, l_ref = JA.apply_augmentations(jnp.asarray(x), key, jcfg, label=jnp.asarray(label))
    draws = _jax_draws(key, jcfg, SHAPE)
    y, lbl = A.apply_augmentations(torch.from_numpy(x).permute(0, 4, 1, 2, 3), cfg,
                                   label=torch.from_numpy(label).permute(0, 4, 1, 2, 3),
                                   draws=draws)
    np.testing.assert_allclose(y.permute(0, 2, 3, 4, 1).numpy(), np.asarray(y_ref),
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(lbl.permute(0, 2, 3, 4, 1).numpy(), np.asarray(l_ref))


def test_port_draws_are_reproducible_by_seed():
    cfg = A.AugmentConfig(mirror_axes=(1, 2, 3), noise_sigma=0.1)
    shape = (4, 2, 6, 5, 4)
    draw = lambda seed: A.draw_augmentations(cfg, shape, torch.Generator().manual_seed(seed))
    a, b, c = draw(0), draw(0), draw(1)
    for u, v, w in zip(a, b, c):
        assert torch.equal(u, v)
        assert not torch.equal(u, w)
    assert a.brightness.shape == a.contrast.shape == (4, 2)
    assert a.gamma.shape == (4,) and a.mirror.shape == (3, 4) and a.noise.shape == shape
    assert bool(((a.gamma >= 0.7) & (a.gamma <= 1.3)).all())
    assert bool(((a.contrast >= 0.3) & (a.contrast <= 1.7)).all())


def test_apply_with_a_generator_moves_label_with_image():
    cfg = A.AugmentConfig(brightness_sigma=0.0, gamma_range=None, contrast_range=None,
                          mirror_axes=(1, 2, 3))
    x = torch.arange(2 * 4 * 4 * 4, dtype=torch.float32).view(2, 1, 4, 4, 4)
    y, lbl = A.apply_augmentations(x, cfg, torch.Generator().manual_seed(3),
                                   label=x.to(torch.uint8))
    assert torch.equal(y.to(torch.uint8), lbl)  # mirror only: both flipped alike
    assert not torch.equal(y, x)


def test_spatial_transform_is_not_ported():
    with pytest.raises(NotImplementedError, match="spatial_3d"):
        A.AugmentConfig(rotate_deg=10.0)
    assert A.AugmentConfig().wants_spatial() is False
