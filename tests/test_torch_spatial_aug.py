"""The port's spatial transform against the JAX package's, given the same draws.

The draws are made with the key splits of ``tpu_mednet/ops/augment.py``
(``spatial_3d``: ``:373-375``; one sample's elastic field, angles and
scale: ``:184-208``) and handed to the port; the JAX functions run under
``jax.jit``, one compiled function per configuration, reused across seeds.
Tolerances:

- ``axis_band`` equal; the rotation matrix within 1 fp32 ulp of 1
  (``cos``/``sin`` of two libraries);
- ``sample_coords`` within 1e-5 voxels (the elastic field's upsample is
  ``F.interpolate`` against ``jax.image.resize``'s weight matrices);
- ``resample_axis`` on the same offsets, in the unrolled (band <= 8) and
  the ``fori_loop`` branch: fp32 within 1e-5 * max |x|, bf16 within one
  bf16 ulp of max |x|, nearest equal;
- ``spatial_3d``, both methods, image in fp32 within 1e-4 * max |x| (the
  source positions differ by the upsample's last bits, scaled by the
  image's gradient), labels equal but where JAX's source coordinate lies
  within 1e-4 of a rounding boundary (``chip_smoke.warp_ambiguous``, which
  follows it through the separable passes), heatmap channels within 1.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import warp_ambiguous
from tpu_mednet.ops import augment as JA
from tpu_mednet_torch.ops import augment as A

SHAPE = (16, 12, 10)    # (X, Y, Z): another extent per axis
N, C, HEATMAPS = 3, 2, 2
CONFIGS = {
    "elastic": dict(elastic_sigma=1.5, rotate_deg=0.0, scale_range=None),
    "affine": dict(elastic_sigma=0.0, rotate_deg=15.0, scale_range=(0.85, 1.15)),
    "all": dict(elastic_sigma=2.0, rotate_deg=10.0, scale_range=(0.9, 1.2)),
}


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def cf(a) -> torch.Tensor:
    """(N, X, Y, Z, C) JAX array -> (N, C, X, Y, Z) torch tensor."""
    return t(a).permute(0, 4, 1, 2, 3)


def cl(x: torch.Tensor) -> np.ndarray:
    return x.permute(0, 2, 3, 4, 1).float().numpy()


def _sample_draws(key, elastic_sigma, elastic_grid, rotate_deg, scale_range):
    """One sample's draws, as ``JA._sample_coords`` makes them."""
    kd, kr, ks = jax.random.split(key, 3)
    g = elastic_grid
    return (elastic_sigma * jax.random.normal(kd, (g, g, g, 3)),
            jax.random.uniform(kr, (3,), minval=-rotate_deg, maxval=rotate_deg)
            * (jnp.pi / 180.0),
            jax.random.uniform(ks, (), minval=scale_range[0], maxval=scale_range[1])
            if scale_range is not None else jnp.zeros(()))


@functools.lru_cache(maxsize=None)
def _jax_draws_fn(n, elastic_sigma, elastic_grid, rotate_deg, scale_range, p):
    def draws(key):
        k_par, k_p = jax.random.split(key)
        keys = jax.random.split(k_par, n)
        apply = jax.random.bernoulli(k_p, p, (n,))
        return (apply, *jax.vmap(lambda k: _sample_draws(
            k, elastic_sigma, elastic_grid, rotate_deg, scale_range))(keys), keys)
    return jax.jit(draws)


def jax_spatial_draws(key, n, elastic_sigma=0.0, elastic_grid=4, rotate_deg=0.0,
                      scale_range=None, p=1.0):
    """``spatial_3d``'s draws under ``key`` as the port's ``SpatialDraws``,
    and the per-sample keys ``_sample_coords`` gets."""
    apply, elastic, angles, scale, keys = _jax_draws_fn(
        n, elastic_sigma, elastic_grid, rotate_deg, scale_range, p)(key)
    return A.SpatialDraws(t(apply), t(elastic) if elastic_sigma else None,
                          t(angles) if rotate_deg else None,
                          t(scale) if scale_range is not None else None), keys


@functools.lru_cache(maxsize=None)
def _jax_coords_fn(shape, elastic_sigma, elastic_grid, rotate_deg, scale_range):
    return jax.jit(jax.vmap(lambda k: JA._sample_coords(
        k, shape, elastic_sigma, elastic_grid, rotate_deg, scale_range)))


@functools.lru_cache(maxsize=None)
def _jax_spatial_fn(method, label_trilinear_channels, p, elastic_sigma, rotate_deg,
                    scale_range):
    return jax.jit(lambda x, key, label: JA.spatial_3d(
        x, key, label=label, elastic_sigma=elastic_sigma, rotate_deg=rotate_deg,
        scale_range=scale_range, p=p, method=method,
        label_trilinear_channels=label_trilinear_channels))


def _batch(seed):
    """A smooth two-channel image and a label of two uint8 Gaussian heatmaps
    and a class map, channels-last."""
    rng = np.random.default_rng(seed)
    grid = np.stack(np.meshgrid(*[np.arange(s) for s in SHAPE], indexing="ij"), -1)
    img = np.empty((N, *SHAPE, C), np.float32)
    lbl = np.empty((N, *SHAPE, HEATMAPS + 1), np.uint8)
    for i in range(N):
        f = rng.uniform(0.2, 0.6, size=(C, 3))
        img[i] = np.stack([np.sin(grid @ f[c]) for c in range(C)], -1) \
            + 0.1 * rng.normal(size=(*SHAPE, C))
        for h in range(HEATMAPS):
            centre = rng.uniform(3, np.asarray(SHAPE) - 3)
            d2 = ((grid - centre) ** 2).sum(-1)
            lbl[i, ..., h] = (255.0 * np.exp(-d2 / (2 * 2.0**2))).astype(np.uint8)
        lbl[i, ..., -1] = (img[i, ..., 0] > 0.3) + (img[i, ..., 1] > 0.5)
    return img, lbl


# -- the geometry helpers --------------------------------------------------------

@pytest.mark.parametrize("shape", [(96, 96, 96), (128, 128, 128), SHAPE])
def test_axis_band_matches_jax(shape):
    for kw in (*CONFIGS.values(), dict(elastic_sigma=4.0, rotate_deg=0.0, scale_range=None),
               dict(elastic_sigma=0.0, rotate_deg=0.0, scale_range=(0.7, 1.0))):
        for axis in range(3):
            assert A.axis_band(shape, axis, **kw) == JA._axis_band(shape, axis, **kw)


def test_rotation_matrix_matches_jax():
    angles = np.random.default_rng(0).uniform(-np.pi / 4, np.pi / 4, size=(8, 3))
    angles = angles.astype(np.float32)
    ref = np.stack([np.asarray(JA._rotation_matrix(jnp.asarray(a))) for a in angles])
    got = A.rotation_matrix(torch.from_numpy(angles)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=np.spacing(np.float32(1)))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_sample_coords_matches_jax(name, seed):
    kw = CONFIGS[name]
    draws, keys = jax_spatial_draws(jax.random.PRNGKey(seed), N, **kw)
    ref = np.asarray(_jax_coords_fn(SHAPE, kw["elastic_sigma"], 4, kw["rotate_deg"],
                                    kw["scale_range"])(keys))
    got = A.sample_coords(SHAPE, draws).permute(0, 2, 3, 4, 1).numpy()
    assert np.abs(got - ref).max() <= 1e-5


# -- the separable warp --------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_resample_fn(axis, band, nearest):
    return jax.jit(lambda v, off: JA.resample_axis(v, off, axis, band, nearest=nearest))


@pytest.mark.parametrize("dtype", ["fp32", "bf16", "nearest"])
@pytest.mark.parametrize("axis,band", [(0, 3), (1, 8), (0, 11), (2, 9)],
                         ids=["unrolled-x", "unrolled-y-8", "loop-x", "loop-z"])
def test_resample_axis_matches_jax(axis, band, dtype):
    rng = np.random.default_rng(axis + 10 * band)
    vol = rng.normal(size=(*SHAPE, C)).astype(np.float32)
    off = rng.uniform(-band, band, size=(*SHAPE, 1)).astype(np.float32)
    # whole and half voxels too: the tent's ends and the nearest pick's ties
    off.reshape(-1)[::7] = np.round(off.reshape(-1)[::7] * 2) / 2
    jdt = {"fp32": jnp.float32, "bf16": jnp.bfloat16, "nearest": jnp.uint8}[dtype]
    if dtype == "nearest":
        vol = rng.integers(0, 255, size=(*SHAPE, C)).astype(np.uint8)
    v = jnp.asarray(vol).astype(jdt)
    ref = np.asarray(_jax_resample_fn(axis, band, dtype == "nearest")(
        v, jnp.asarray(off)).astype(jnp.float32))
    got = A.resample_axis(cf(np.asarray(v.astype(jnp.float32))[None]).to(
        {"fp32": torch.float32, "bf16": torch.bfloat16, "nearest": torch.uint8}[dtype]),
        cf(off[None]), axis, nearest=dtype == "nearest")
    got = cl(got)[0]
    peak = float(np.abs(np.asarray(v.astype(jnp.float32))).max())
    if dtype == "nearest":
        np.testing.assert_array_equal(got, ref)
    elif dtype == "bf16":
        ulp = 2.0 ** (np.floor(np.log2(peak)) - 7)
        assert np.abs(got - ref).max() <= ulp
    else:
        assert np.abs(got - ref).max() <= 1e-5 * peak


# -- spatial_3d and apply_augmentations ----------------------------------------------

@pytest.mark.parametrize("trilinear", [0, HEATMAPS], ids=["nearest-labels", "heatmaps-linear"])
@pytest.mark.parametrize("method", ["separable", "exact"])
def test_spatial_3d_matches_jax(method, trilinear):
    kw, p = CONFIGS["all"], 0.6
    fn = _jax_spatial_fn(method, trilinear, p, kw["elastic_sigma"], kw["rotate_deg"],
                         kw["scale_range"])
    coords_fn = _jax_coords_fn(SHAPE, kw["elastic_sigma"], 4, kw["rotate_deg"],
                               kw["scale_range"])
    bands = [JA._axis_band(SHAPE, ax, **kw) for ax in range(3)]
    seen = []
    for seed in (0, 1, 4):  # JAX's key 4 leaves samples 0 and 2 alone
        img, lbl = _batch(seed)
        key = jax.random.PRNGKey(seed)
        y_ref, l_ref = (np.asarray(a) for a in fn(jnp.asarray(img), key, jnp.asarray(lbl)))
        draws, keys = jax_spatial_draws(key, N, p=p, **kw)
        y, lab = A.spatial_3d(cf(img), draws, label=cf(lbl), method=method,
                              label_trilinear_channels=trilinear, **kw)
        assert y.dtype == torch.float32 and lab.dtype == torch.uint8
        assert np.abs(cl(y) - y_ref).max() <= 1e-4 * np.abs(img).max()
        amb = warp_ambiguous(np.asarray(coords_fn(keys)), draws.apply, method, bands)
        lab = cl(lab).astype(np.int16)
        l_ref = l_ref.astype(np.int16)
        nearest = slice(trilinear, None)
        assert (lab[..., nearest] != l_ref[..., nearest])[~amb].sum() == 0
        assert amb.mean() < 0.01
        assert np.abs(lab[..., :trilinear] - l_ref[..., :trilinear]).max(initial=0) <= 1
        # the samples whose apply bit is off pass unchanged
        off = ~draws.apply.numpy()
        np.testing.assert_array_equal(cl(y)[off], img[off])
        np.testing.assert_array_equal(lab[off], lbl[off])
        seen.extend(draws.apply.tolist())
    assert any(seen) and not all(seen)


def test_separable_close_to_exact_for_small_deformations():
    """``tests/test_spatial_aug.py``'s check, in the port: a small elastic
    field on a smooth image."""
    g = np.stack(np.meshgrid(*[np.arange(16)] * 3, indexing="ij"), -1).astype(np.float32)
    x = torch.from_numpy(np.sin(g[..., 0] * 0.4) + np.cos(g[..., 1] * 0.3)
                         + np.sin(g[..., 2] * 0.5))[None, None]
    draws = A.draw_spatial(1, torch.Generator().manual_seed(3), elastic_sigma=1.5)
    ysep = A.spatial_3d(x, draws, elastic_sigma=1.5, method="separable").numpy()
    yex = A.spatial_3d(x, draws, elastic_sigma=1.5, method="exact").numpy()
    assert (ysep != x.numpy()).any()
    span = float(x.max() - x.min())
    assert np.abs(ysep - yex).mean() < 0.05 * span
    assert np.corrcoef(ysep.ravel(), yex.ravel())[0, 1] > 0.97
    with pytest.raises(ValueError, match="method"):
        A.spatial_3d(x, draws, elastic_sigma=1.5, method="bogus")


def _jax_intensity_draws(key, cfg, shape):
    """The rest of ``apply_augmentations``' draws (its key splits), channels-first."""
    n, c = shape[0], shape[-1]
    k_b, k_g, k_c, k_m, _, k_s = jax.random.split(key, 6)
    offs = cfg.brightness_mu + cfg.brightness_sigma * jax.random.normal(
        k_b, (n, 1, 1, 1, c), dtype=jnp.float32)
    g = jax.random.uniform(k_g, (n, 1, 1, 1, 1), dtype=jnp.float32,
                           minval=cfg.gamma_range[0], maxval=cfg.gamma_range[1])
    f = jax.random.uniform(k_c, (n, 1, 1, 1, c), dtype=jnp.float32,
                           minval=cfg.contrast_range[0], maxval=cfg.contrast_range[1])
    flips = [jax.random.bernoulli(k, 0.5, (n, 1, 1, 1, 1))
             for k in jax.random.split(k_m, len(cfg.mirror_axes))]
    return dict(brightness=t(offs).view(n, c), gamma=t(g).view(n), contrast=t(f).view(n, c),
                mirror=torch.stack([t(fl).view(n) for fl in flips])), k_s


def test_apply_augmentations_with_spatial_matches_jax():
    kw = CONFIGS["all"]
    jcfg = JA.AugmentConfig(mirror_axes=(1, 2, 3), spatial_prob=0.6,
                            label_trilinear_channels=HEATMAPS, **kw)
    cfg = A.AugmentConfig(mirror_axes=(1, 2, 3), spatial_prob=0.6,
                          label_trilinear_channels=HEATMAPS, **kw)
    assert cfg.wants_spatial() and not A.AugmentConfig().wants_spatial()
    img, lbl = _batch(2)
    key = jax.random.PRNGKey(5)
    y_ref, l_ref = jax.jit(lambda x, k, lab: JA.apply_augmentations(x, k, jcfg, label=lab))(
        jnp.asarray(img), key, jnp.asarray(lbl))
    rest, k_s = _jax_intensity_draws(key, jcfg, img.shape)
    spatial, keys = jax_spatial_draws(k_s, N, p=0.6, **kw)
    y, lab = A.apply_augmentations(cf(img), cfg, label=cf(lbl),
                                   draws=A.AugmentDraws(spatial=spatial, **rest))
    y_ref, l_ref = np.asarray(y_ref), np.asarray(l_ref).astype(np.int16)
    assert np.abs(cl(y) - y_ref).max() <= 1e-4 * np.abs(y_ref).max()
    bands = [JA._axis_band(SHAPE, ax, **kw) for ax in range(3)]
    amb = warp_ambiguous(np.asarray(_jax_coords_fn(SHAPE, kw["elastic_sigma"], 4,
                                               kw["rotate_deg"], kw["scale_range"])(keys)),
                     spatial.apply, "separable", bands)
    for axis, flip in zip(cfg.mirror_axes, rest["mirror"].numpy()):
        amb = np.where(flip.reshape(-1, 1, 1, 1), np.flip(amb, axis), amb)
    lab = cl(lab).astype(np.int16)
    assert (lab[..., -1] != l_ref[..., -1])[~amb].sum() == 0
    assert np.abs(lab[..., :HEATMAPS] - l_ref[..., :HEATMAPS]).max() <= 1


def test_spatial_draws_leave_the_stream_alone_when_off():
    """With the spatial transform off, a batch's draws are what they were
    before it existed; with it on, they come first and are reproducible."""
    shape = (4, 1, 8, 8, 8)
    plain = A.AugmentConfig(mirror_axes=(1, 2, 3), noise_sigma=0.1)
    spatial = A.AugmentConfig(mirror_axes=(1, 2, 3), noise_sigma=0.1, **CONFIGS["all"])
    a = A.draw_augmentations(plain, shape, torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(0)
    want = (torch.randn((4, 1), generator=g) * 0.3, 0.7 + 0.6 * torch.rand((4,), generator=g))
    assert a.spatial is None
    assert torch.equal(a.brightness, want[0]) and torch.equal(a.gamma, want[1])
    b = A.draw_augmentations(spatial, shape, torch.Generator().manual_seed(0))
    c = A.draw_augmentations(spatial, shape, torch.Generator().manual_seed(0))
    assert b.spatial.elastic.shape == (4, 4, 4, 4, 3) and b.spatial.angles.shape == (4, 3)
    assert bool((b.spatial.angles.abs() <= np.deg2rad(10.0)).all())
    assert bool(((b.spatial.scale >= 0.9) & (b.spatial.scale <= 1.2)).all())
    for u, v in zip(b.spatial, c.spatial):
        assert torch.equal(u, v)
    assert not torch.equal(a.brightness, b.brightness)


def test_trainer_sets_heatmap_channels_like_jax():
    """The Trainer's hook (``tpu_mednet/train/loop.py:331-339``): with the
    spatial transform on, a landmark task's heatmap channels warp
    linearly; an explicit value wins; a segmentation task stays nearest."""
    from tpu_mednet import tasks as jax_tasks
    from tpu_mednet.models import UNet3DBase, UNetConfig
    from tpu_mednet.train import Trainer as JaxTrainer
    from tpu_mednet_torch import tasks
    from tpu_mednet_torch.models import ResidualUNet3D
    from tpu_mednet_torch.train import Trainer

    def models(out):
        return (UNet3DBase(config=UNetConfig(in_channels=1, out_channels=out, f_maps=4,
                                             num_levels=2, num_groups=2, dtype=jnp.float32)),
                ResidualUNet3D(1, out, f_maps=4, num_levels=2, num_groups=2,
                               dtype=torch.float32, device="cpu"))

    weights = [0.01] * HEATMAPS
    jm, pm = models(HEATMAPS + 2)
    jtask = jax_tasks.LandmarkTask(model=jm, loss_regression_weight=weights)
    task = tasks.LandmarkTask(model=pm, loss_regression_weight=weights)
    jm, pm = models(2)
    jseg, seg = jax_tasks.SegmentationTask(model=jm), tasks.SegmentationTask(model=pm)
    class Sampler(list):  # the Trainers read its length and patch size only
        patch_size = (8, 8, 8)

    sampler = Sampler([None] * 8)
    for spatial, explicit in (({}, 0), (CONFIGS["elastic"], 0), (CONFIGS["elastic"], 1)):
        jcfg = JA.AugmentConfig(label_trilinear_channels=explicit, **spatial)
        cfg = A.AugmentConfig(label_trilinear_channels=explicit, **spatial)
        for jt, pt in ((jtask, task), (jseg, seg)):
            ref = JaxTrainer(jt, sampler, batch_size=2, max_epochs=1, augment=jcfg).augment
            got = Trainer(pt, sampler, batch_size=2, max_epochs=1, augment=cfg).augment
            assert got.label_trilinear_channels == ref.label_trilinear_channels
    assert Trainer(task, sampler, batch_size=2, max_epochs=1, augment=A.AugmentConfig(
        elastic_sigma=1.0)).augment.label_trilinear_channels == task.num_heatmaps
