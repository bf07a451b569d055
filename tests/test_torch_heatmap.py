"""The port's heatmap synthesis, landmark losses and readout against the JAX package's.

Same numpy inputs (seeded) through both packages on the CPU.  Tolerances:

- ``gaussian_heatmap`` / ``batched_gaussian_heatmaps``: fp32 atol 1e-3 on
  the 0..255 scale (the frameworks' ``exp`` may differ by an ulp), with
  fractional, out-of-crop and sentinel (< -1000) coordinates;
- ``heatmap_argmax_coords``, ``heatmap_peaks``, ``landmark_readout``: exact;
- ``mse_loss``, ``l1_loss``, ``landmark_loss`` and
  ``multitask_landmark_loss`` for each class/regression combination, with
  and without class weights: rtol 1e-6 and atol 1e-6, and their gradients
  with respect to both heads the same.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_mednet.ops import heatmap as jax_hm
from tpu_mednet.ops import losses as jax_losses
from tpu_mednet.utils import evaluation as jax_eval
from tpu_mednet_torch.ops import heatmap, losses
from tpu_mednet_torch.utils import evaluation

SHAPE = (12, 10, 14)
COORDS = np.asarray([[3.0, 4.0, 5.0],        # on a voxel
                     [7.25, 1.5, 12.75],     # fractional, near an edge
                     [-3.0, 5.0, 20.0],      # outside the crop: a tail renders
                     [-9999.0, 2.0, 2.0]],   # missing-landmark sentinel
                    np.float32)


def _to_cl(x: np.ndarray) -> np.ndarray:
    """(..., C, X, Y, Z) -> (..., X, Y, Z, C)."""
    return np.moveaxis(x, -4, -1)


@pytest.mark.parametrize("sigma", [2.0, [1.5, 2.0, 3.0, 2.5]])
def test_gaussian_heatmap_matches_jax(sigma):
    got = heatmap.gaussian_heatmap(torch.from_numpy(COORDS), SHAPE, sigma)
    want = np.asarray(jax_hm.gaussian_heatmap(jnp.asarray(COORDS), SHAPE,
                                              jnp.asarray(sigma)))
    assert got.shape == (4, *SHAPE) and got.dtype == torch.float32
    np.testing.assert_allclose(_to_cl(got.numpy()), want, rtol=0, atol=1e-3)
    assert float(got[0, 3, 4, 5]) == 255.0
    assert float(got[2].max()) > 0 and not got[3].any()


def test_batched_gaussian_heatmaps_match_jax():
    rng = np.random.default_rng(0)
    coords = rng.uniform(-4, 16, size=(3, 4, 3)).astype(np.float32)
    coords[1, 2] = -5000.0
    got = heatmap.batched_gaussian_heatmaps(torch.from_numpy(coords), SHAPE, 3.0)
    want = np.asarray(jax_hm.batched_gaussian_heatmaps(jnp.asarray(coords), SHAPE, 3.0))
    assert got.shape == (3, 4, *SHAPE)
    np.testing.assert_allclose(_to_cl(got.numpy()), want, rtol=0, atol=1e-3)
    assert not got[1, 2].any()
    with pytest.raises(ValueError, match=r"\(N, L, 3\)"):
        heatmap.batched_gaussian_heatmaps(torch.zeros(4, 3), SHAPE, 1.0)
    with pytest.raises(ValueError, match=r"\(L, 3\)"):
        heatmap.gaussian_heatmap(torch.zeros(2, 4, 3), SHAPE, 1.0)


@pytest.mark.parametrize("sigma", [4.0, [1.5, 2.0, 3.0, 2.5]])
def test_heatmaps_from_a_sigma_tensor_equal_those_from_floats(sigma):
    """The device sampler hands σ over as an fp32 tensor made once: the
    heatmaps are those of the float or the list, bit for bit."""
    rng = np.random.default_rng(3)
    coords = torch.from_numpy(rng.uniform(-4, 16, size=(3, 4, 3)).astype(np.float32))
    coords[1, 2] = -5000.0
    want = heatmap.batched_gaussian_heatmaps(coords, SHAPE, sigma)
    got = heatmap.batched_gaussian_heatmaps(coords, SHAPE,
                                            torch.tensor(sigma, dtype=torch.float32))
    assert want.any()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("ties", [False, True])
def test_heatmap_argmax_coords_match_jax(ties):
    rng = np.random.default_rng(1)
    hm = rng.normal(size=(2, 3, *SHAPE)).astype(np.float32)
    if ties:  # few distinct values: the first maximum in x, y, z order wins
        hm = rng.integers(0, 3, size=hm.shape).astype(np.float32)
    got = heatmap.heatmap_argmax_coords(torch.from_numpy(hm))
    want = np.asarray(jax_hm.heatmap_argmax_coords(jnp.asarray(_to_cl(hm))))
    assert got.shape == (2, 3, 3)
    np.testing.assert_array_equal(got.numpy(), want)


def _heads(seed=2, n_hm=3, n_cls=2):
    rng = np.random.default_rng(seed)
    shape = (2, 6, 5, 4)
    out_hm = rng.normal(0, 40, size=(2, n_hm, *shape[1:])).astype(np.float32)
    out_cls = rng.normal(size=(2, n_cls, *shape[1:])).astype(np.float32)
    hm = rng.integers(0, 256, size=(2, n_hm, *shape[1:])).astype(np.float32)
    labels = rng.integers(0, n_cls, size=shape).astype(np.int64)
    return out_hm, out_cls, hm, labels


@pytest.mark.parametrize("name", ["mse_loss", "l1_loss", "landmark_loss"])
def test_regression_losses_and_gradients_match_jax(name):
    out_hm, _, hm, _ = _heads()
    pred = torch.from_numpy(out_hm).requires_grad_()
    got = getattr(losses, name)(pred, torch.from_numpy(hm))
    got.backward()
    fn = lambda p: getattr(jax_losses, name)(p, jnp.asarray(_to_cl(hm)))
    want, grad = jax.value_and_grad(fn)(jnp.asarray(_to_cl(out_hm)))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(_to_cl(pred.grad.numpy()), np.asarray(grad), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("class_weight", [None, [0.05, 1.0]])
@pytest.mark.parametrize("regression", ["L2", "L1"])
@pytest.mark.parametrize("class_loss", ["DICE", "CE"])
def test_multitask_landmark_loss_and_gradients_match_jax(class_loss, regression,
                                                          class_weight):
    out_hm, out_cls, hm, labels = _heads()
    weights = [0.015, 0.001, 0.02]
    t_hm = torch.from_numpy(out_hm).requires_grad_()
    t_cls = torch.from_numpy(out_cls).requires_grad_()
    got = losses.multitask_landmark_loss(t_cls, t_hm, torch.from_numpy(labels),
                                         torch.from_numpy(hm), weights, class_loss,
                                         class_weight, regression)
    got[0].backward()

    cw = None if class_weight is None else jnp.asarray(class_weight, jnp.float32)

    def fn(o_cls, o_hm):
        total, cls, reg = jax_losses.multitask_landmark_loss(
            o_cls, o_hm, jnp.asarray(labels), jnp.asarray(_to_cl(hm)), weights,
            class_loss, cw, regression)
        return total, (cls, reg)

    (total, (cls, reg)), (g_cls, g_hm) = jax.value_and_grad(fn, argnums=(0, 1), has_aux=True)(
        jnp.asarray(_to_cl(out_cls)), jnp.asarray(_to_cl(out_hm)))
    for a, b in zip(got, (total, cls, reg)):
        np.testing.assert_allclose(float(a.detach()), float(b), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(_to_cl(t_cls.grad.numpy()), np.asarray(g_cls), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(_to_cl(t_hm.grad.numpy()), np.asarray(g_hm), rtol=1e-6,
                               atol=1e-6)


def test_multitask_landmark_loss_refuses_unknown_losses():
    out_hm, out_cls, hm, labels = [torch.from_numpy(a) for a in _heads()]
    with pytest.raises(ValueError, match="class_loss"):
        losses.multitask_landmark_loss(out_cls, out_hm, labels, hm, [1, 1, 1], "BCE")
    with pytest.raises(ValueError, match="regression_loss"):
        losses.multitask_landmark_loss(out_cls, out_hm, labels, hm, [1, 1, 1],
                                       regression_loss="L3")


@pytest.mark.parametrize("affine", [None, np.diag([0.8, 0.8, 1.5, 1.0])])
def test_landmark_readout_matches_jax(affine):
    rng = np.random.default_rng(3)
    vol = rng.integers(0, 200, size=(4, *SHAPE)).astype(np.uint8)
    vol[1] = 0  # a landmark found nowhere reads peak 0
    vol[0, 5, 6, 7] = 255
    got = evaluation.landmark_readout(vol, 3, affine=affine)
    want = jax_eval.landmark_readout(vol, 3, affine=affine)
    assert got == want
    assert got[0]["voxel"] == [5.0, 6.0, 7.0] and got[1]["peak"] == 0.0
    np.testing.assert_array_equal(evaluation.heatmap_peaks(vol[:3].astype(np.float32)),
                                  jax_eval.heatmap_peaks(vol[:3].astype(np.float32)))
