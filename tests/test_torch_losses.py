"""The port's segmentation losses and metrics against the JAX package's.

Same numpy logits and labels; the JAX side takes channels-last logits,
the port channels-first.  Values and d(loss)/d(logits) (``jax.value_and_grad``
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


def _assert_close(got, ref):
    assert abs(got[0] - ref[0]) <= 1e-6, (got[0], ref[0])
    np.testing.assert_allclose(got[1], ref[1], rtol=0, atol=1e-6)


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


@pytest.mark.parametrize("case", list(CASES))
def test_loss_value_and_grad_match_jax(case):
    jax_fn, port_fn, ignore = CASES[case]
    logits, labels = _data(seed=len(case), ignore=ignore)
    got, ref = _both(jax_fn, port_fn, logits, labels)
    _assert_close(got, ref)


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
    for fn in (L.dice_loss, L.ce_loss):
        with pytest.raises(ValueError, match="per-class weight has 2 entries"):
            fn(z, torch.from_numpy(labels), weight=[1.0, 2.0])
