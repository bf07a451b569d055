"""The port's segmentation losses and metrics against the JAX package's.

Same numpy logits and labels (one-hot, BCE and per-voxel weight targets
made from them by each package's own ``expand_as_one_hot``); the JAX side
takes channels-last logits, the port channels-first.  Values and d(loss)/d(logits) (``jax.value_and_grad``
against torch autograd) agree at fp32 atol 1e-6: the same formulas, with
the sums over voxels taken in other orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_mednet.ops import losses as JL
from tpu_mednet_torch.ops import losses as L

SHAPE = (2, 6, 5, 4)
CLASSES = 3


def _data(seed=0, ignore=None):
    rng = np.random.default_rng(seed)
    logits = rng.normal(0.0, 2.0, size=(*SHAPE, CLASSES)).astype(np.float32)
    labels = rng.integers(0, CLASSES, size=SHAPE).astype(np.int32)
    if ignore is not None:
        labels[rng.random(SHAPE) < 0.2] = ignore
    return logits, labels


def _both(jax_fn, port_fn, logits, labels):
    """(value, grad) of the JAX loss and of the port's, grads channels-last."""
    v_ref, g_ref = jax.value_and_grad(lambda z: jax_fn(z, jnp.asarray(labels)))(
        jnp.asarray(logits))
    z = torch.from_numpy(logits).permute(0, 4, 1, 2, 3).clone().requires_grad_()
    v = port_fn(z, torch.from_numpy(labels))
    v.backward()
    return (float(v.detach()), z.grad.permute(0, 2, 3, 4, 1).numpy()), (float(v_ref), np.asarray(g_ref))


def _assert_close(got, ref, rtol=(0.0, 0.0)):
    """Value and gradient within atol 1e-6 plus ``rtol`` (value, gradient)."""
    assert abs(got[0] - ref[0]) <= 1e-6 + rtol[0] * abs(ref[0]), (got[0], ref[0])
    np.testing.assert_allclose(got[1], ref[1], rtol=rtol[1], atol=1e-6)


WEIGHT = [0.2, 1.0, 2.5]

CASES = {
    "dice": (lambda z, y: JL.dice_loss(z, y), lambda z, y: L.dice_loss(z, y), None),
    "dice-weighted": (lambda z, y: JL.dice_loss(z, y, weight=jnp.asarray(WEIGHT)),
                      lambda z, y: L.dice_loss(z, y, weight=WEIGHT), None),
    "ce": (lambda z, y: JL.ce_loss(z, y), lambda z, y: L.ce_loss(z, y), None),
    "ce-weighted": (lambda z, y: JL.ce_loss(z, y, weight=jnp.asarray(WEIGHT)),
                    lambda z, y: L.ce_loss(z, y, weight=WEIGHT), None),
    "ce-ignore": (lambda z, y: JL.ce_loss(z, y, ignore_index=-1),
                  lambda z, y: L.ce_loss(z, y, ignore_index=-1), -1),
    "ce-weighted-ignore": (
        lambda z, y: JL.ce_loss(z, y, weight=jnp.asarray(WEIGHT), ignore_index=-1),
        lambda z, y: L.ce_loss(z, y, weight=WEIGHT, ignore_index=-1), -1),
    "ce-double-softmax": (lambda z, y: JL.ce_loss(z, y, double_softmax=True),
                          lambda z, y: L.ce_loss(z, y, double_softmax=True), None),
}


def _jax_onehot(y, classes=CLASSES, ignore_index=None):
    return JL.expand_as_one_hot(y, classes, ignore_index=ignore_index)


def _onehot(y, classes=CLASSES, ignore_index=None):
    return L.expand_as_one_hot(y, classes, ignore_index=ignore_index)


def _voxel_weights(y):
    """A per-voxel weight map in [0.5, 2) of the labels' shape, the same for
    both packages (``y`` is a JAX or a torch array of one shape)."""
    return np.random.default_rng(11).uniform(0.5, 2.0, size=SHAPE).astype(np.float32)


# (value, gradient) rtol beside atol 1e-6, by case; 0 where not listed
RTOL = {}

# the losses no task calls (ops/losses.py:176-261): the data-weighted CE on
# one-hot and integer targets, the masked BCE on logits, on probabilities
# and with the last target channel skipped, the per-voxel weighted CE
CASES.update({
    "wce-onehot": (lambda z, y: JL.weighted_ce_loss(z, _jax_onehot(y)),
                   lambda z, y: L.weighted_ce_loss(z, _onehot(y)), None),
    "wce-labels-weighted": (
        lambda z, y: JL.weighted_ce_loss(z, y, weight=jnp.asarray(WEIGHT),
                                         target_one_hot_encoded=False),
        lambda z, y: L.weighted_ce_loss(z, y, weight=WEIGHT, target_one_hot_encoded=False),
        -1),
    "bce-ignore": (lambda z, y: JL.bce_with_masking(z, _jax_onehot(y, ignore_index=-1)),
                   lambda z, y: L.bce_with_masking(z, _onehot(y, ignore_index=-1)), -1),
    "bce-skip-last": (
        lambda z, y: JL.bce_with_masking(z, _jax_onehot(y, CLASSES + 1), ignore_index=None,
                                         skip_last_target=True),
        lambda z, y: L.bce_with_masking(z, _onehot(y, CLASSES + 1), ignore_index=None,
                                        skip_last_target=True), None),
    "bce-probabilities": (
        lambda z, y: JL.bce_with_masking(jax.nn.sigmoid(z), _jax_onehot(y), with_logits=False),
        lambda z, y: L.bce_with_masking(torch.sigmoid(z), _onehot(y), with_logits=False),
        None),
    "pixelwise-ce": (
        lambda z, y: JL.pixelwise_ce_loss(z, y, jnp.asarray(_voxel_weights(y))),
        lambda z, y: L.pixelwise_ce_loss(z, y, torch.from_numpy(_voxel_weights(y))), None),
    "pixelwise-ce-class-weighted-ignore": (
        lambda z, y: JL.pixelwise_ce_loss(z, y, jnp.asarray(_voxel_weights(y)),
                                          class_weights=jnp.asarray(WEIGHT), ignore_index=-1),
        lambda z, y: L.pixelwise_ce_loss(z, y, torch.from_numpy(_voxel_weights(y)),
                                         class_weights=WEIGHT, ignore_index=-1), -1),
})
# rtol 1e-6 for the losses no task calls, but the weighted CE's value: its
# mean divides by a sum of 240 data-derived voxel weights, which XLA's CPU
# sums in sequence (measured 1.5e-6 relative from float64 at the first
# case's weights, the port's 2e-7), so it is held at the fp32 error bound
# of such a sum, 240 * 2^-24 = 1.4e-5
RTOL.update(dict.fromkeys([k for k in CASES if k.startswith(("wce", "bce", "pixelwise"))],
                          (1e-6, 1e-6)))
RTOL.update(dict.fromkeys([k for k in CASES if k.startswith("wce")], (1.4e-5, 1e-6)))


@pytest.mark.parametrize("case", list(CASES))
def test_loss_value_and_grad_match_jax(case):
    jax_fn, port_fn, ignore = CASES[case]
    logits, labels = _data(seed=len(case), ignore=ignore)
    got, ref = _both(jax_fn, port_fn, logits, labels)
    _assert_close(got, ref, rtol=RTOL.get(case, (0.0, 0.0)))


def test_dice_metric_matches_jax():
    logits, labels = _data(seed=7)
    ref = np.asarray(JL.dice_metric(jnp.asarray(logits), jnp.asarray(labels)))
    got = L.dice_metric(torch.from_numpy(logits).permute(0, 4, 1, 2, 3),
                        torch.from_numpy(labels))
    assert got.shape == (CLASSES,)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)


def test_one_hot_and_flatten_match_jax():
    _, labels = _data(seed=8, ignore=5)
    ref = np.asarray(JL.expand_as_one_hot(jnp.asarray(labels), CLASSES, ignore_index=5))
    got = L.expand_as_one_hot(torch.from_numpy(labels), CLASSES, ignore_index=5)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 4, 1).numpy(), ref)
    np.testing.assert_array_equal(L.flatten_channels(got).numpy(),
                                  np.asarray(JL.flatten_channels(jnp.asarray(ref))))


def test_class_weight_of_the_wrong_length_raises():
    logits, labels = _data()
    z = torch.from_numpy(logits).permute(0, 4, 1, 2, 3)
    for fn in (L.dice_loss, L.ce_loss, L.weighted_ce_loss):
        with pytest.raises(ValueError, match="per-class weight has 2 entries"):
            fn(z, torch.from_numpy(labels), weight=[1.0, 2.0])
