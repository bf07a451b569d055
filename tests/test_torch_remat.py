"""Rematerialization: the port's ``UNetConfig.remat`` against the JAX package's.

``ResidualUNet3D(1, 2, f_maps=8, num_levels=3)`` in fp32, 16³ patches,
batch 2, Dice loss, as ``test_torch_train_step.py``: the JAX package draws
the parameters of a model with ``remat`` 1 or ``True`` and
``load_jax_params`` carries them into the port's model of the same
``remat`` (the parameter names do not change).  Tolerances: against
``jax.grad`` the train step's bounds (the loss atol 1e-5, every gradient
within 1e-4 * max |g|); the port's own remat 1 and ``True`` against remat 0
within 1e-6 * max |g| (the recompute runs the same operations on the same
inputs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_mednet.models import UNet3DBase, UNetConfig
from tpu_mednet.tasks import SegmentationTask as JaxSegmentationTask
from tpu_mednet.train import create_train_state as jax_create_train_state
from tpu_mednet_torch.models import ResidualUNet3D
from tpu_mednet_torch.ops import groupnorm as gn
from tpu_mednet_torch.tasks import SegmentationTask
from tpu_mednet_torch.utils.weights import load_jax_params, state_dict_from_jax

BATCH_SHAPE = (2, 16, 16, 16, 1)
REMATS = {"0": False, "1": 1, "2": 2, "all": True}


def _batch():
    rng = np.random.default_rng(3)
    label = np.zeros(BATCH_SHAPE, np.uint8)
    label[:, 4:12, 3:11, 5:13] = 1
    data = (rng.normal(size=BATCH_SHAPE) + 1.5 * label).astype(np.float32)
    return data, label


def _port_grads(model, data, label):
    """Loss and ``.grad`` of every parameter of one Dice step of ``model``."""
    task = SegmentationTask(model=model, loss="DICE")
    to = lambda a: torch.from_numpy(a).permute(0, 4, 1, 2, 3)
    model.zero_grad(set_to_none=True)
    loss, _ = task.loss_fn(model(to(data)), {"label": to(label)})
    loss.backward()
    return float(loss.detach()), {k: p.grad.clone() for k, p in model.named_parameters()}


@pytest.mark.parametrize("remat", ["1", "all"])
def test_remat_loss_and_gradients_match_jax(remat):
    cfg = UNetConfig(in_channels=1, out_channels=2, f_maps=8, num_levels=3,
                     dtype=jnp.float32, packed=False, remat=REMATS[remat])
    jtask = JaxSegmentationTask(model=UNet3DBase(config=cfg), loss="DICE")
    jstate = jax_create_train_state(jtask.model, BATCH_SHAPE, learning_rate=1e-3, seed=0)
    data, label = _batch()
    jbatch = {"data": jnp.asarray(data), "label": jnp.asarray(label)}

    def loss_of(params):
        out = jtask.model.apply({"params": params}, jbatch["data"], train=True)
        return jtask.loss_fn(out, jbatch)[0]

    loss_ref, grads = jax.jit(jax.value_and_grad(loss_of))(jstate.params)
    grads = state_dict_from_jax({"params": jax.tree.map(np.asarray, grads)})
    model = ResidualUNet3D(1, 2, f_maps=8, num_levels=3, dtype=torch.float32, device="cpu",
                           remat=REMATS[remat])
    load_jax_params(model, {"params": jax.tree.map(np.asarray, jstate.params)})
    loss, got = _port_grads(model, data, label)
    assert abs(loss - float(loss_ref)) <= 1e-5
    assert sorted(got) == sorted(grads)
    for k, g_ref in grads.items():
        scale = float(g_ref.abs().max())
        assert scale > 0, k
        assert float((got[k] - g_ref).abs().max()) <= 1e-4 * scale, k


def test_remat_matches_no_remat_and_recomputes_the_stages():
    """remat 1, 2 and ``True`` give remat 0's loss and gradients; the
    backward recomputes the chosen stages, three GroupNorms each: encoder
    stage i when i < k, the decoder stage whose output level is < k."""
    data, label = _batch()
    ref = None
    for name, remat in REMATS.items():
        model = ResidualUNet3D(1, 2, f_maps=8, num_levels=3, dtype=torch.float32,
                               device="cpu", generator=torch.Generator().manual_seed(0),
                               remat=remat)
        calls = []
        orig = gn.group_norm_moments_plain
        gn.group_norm_moments_plain = lambda *a, **kw: calls.append(1) or orig(*a, **kw)
        try:
            loss, grads = _port_grads(model, data, label)
        finally:
            gn.group_norm_moments_plain = orig
        k = model.config.remat_levels
        stages = min(k, 3) + min(k, 2)  # 3 encoder and 2 decoder stages
        assert len(calls) == 3 * (5 + stages), name
        if ref is None:
            ref = loss, grads
            continue
        assert abs(loss - ref[0]) <= 1e-6
        for key, g in grads.items():
            assert float((g - ref[1][key]).abs().max()) <= 1e-6 * float(
                ref[1][key].abs().max()), (name, key)
    # without gradients nothing is recomputed, and the forward is the same
    x = torch.from_numpy(data).permute(0, 4, 1, 2, 3)
    with torch.no_grad():
        np.testing.assert_array_equal(model(x).numpy(), ResidualUNet3D(
            1, 2, f_maps=8, num_levels=3, dtype=torch.float32, device="cpu",
            generator=torch.Generator().manual_seed(0))(x).numpy())


def test_from_hparams_takes_remat():
    from types import SimpleNamespace

    from tpu_mednet_torch.tasks import LandmarkTask

    for value, want in (("0", 0), ("1", 1), ("all", 3), ("2", 2)):
        hp = SimpleNamespace(in_channels=1, out_channels=4, fmaps=[4, 8, 16], bf16=False,
                             remat=value, loss_regression_weight=[0.1, 0.1])
        for cls in (SegmentationTask, LandmarkTask):
            assert cls.from_hparams(hp, device="cpu").model.config.remat_levels == want
