"""The port's train and eval steps against the JAX package's, on the CPU.

``ResidualUNet3D(1, 2, f_maps=8, num_levels=3)`` in fp32, 16³ patches,
batch 2, Dice loss, no augmentation: the JAX package's
``create_train_state`` draws the parameters, ``load_jax_params`` carries
them into the port, and both steps take the same numpy batch.

Tolerances: the loss atol 1e-5, and every gradient leaf within
1e-4 * max |g| of ``jax.grad`` (the frameworks sum convolutions and
GroupNorm statistics in other orders: the forward's own bound,
docs/PERFORMANCE.md:389-390, carried through the backward); Adam against
``optax.adam`` on identical gradients over 3 steps at rtol 1e-6 and atol
1e-8 = 1e-5 * lr (the same update, rounded in another order: torch folds
the bias corrections into the step size and the denominator, optax into
the moments, which moves a near-zero parameter by up to ~1e-8); eval
metrics atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpu_mednet.models import UNet3DBase, UNetConfig
from tpu_mednet.tasks import SegmentationTask as JaxSegmentationTask
from tpu_mednet.train import create_train_state as jax_create_train_state
from tpu_mednet.train import make_eval_step as jax_make_eval_step
from tpu_mednet.train import make_train_step as jax_make_train_step
from tpu_mednet_torch.models import ResidualUNet3D
from tpu_mednet_torch.ops.augment import AugmentConfig
from tpu_mednet_torch.tasks import SegmentationTask
from tpu_mednet_torch.train import (create_train_state, make_eval_step, make_train_step,
                                    param_count)
from tpu_mednet_torch.utils.weights import load_jax_params, state_dict_from_jax

BATCH_SHAPE = (2, 16, 16, 16, 1)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    label = np.zeros(BATCH_SHAPE, np.uint8)
    label[:, 4:12, 3:11, 5:13] = 1
    data = (rng.normal(size=BATCH_SHAPE) + 1.5 * label).astype(np.float32)
    return data, label


def _port_batch(data, label):
    to = lambda a: torch.from_numpy(a).permute(0, 4, 1, 2, 3)
    return {"data": to(data), "label": to(label)}


def _setup(packed=False):
    """(JAX task, JAX state, port task, port state) from the same parameters."""
    cfg = UNetConfig(in_channels=1, out_channels=2, f_maps=8, num_levels=3,
                     dtype=jnp.float32, packed=packed)
    jtask = JaxSegmentationTask(model=UNet3DBase(config=cfg), loss="DICE")
    jstate = jax_create_train_state(jtask.model, BATCH_SHAPE, learning_rate=1e-3, seed=0)
    model = ResidualUNet3D(1, 2, f_maps=8, num_levels=3, dtype=torch.float32, device="cpu")
    load_jax_params(model, {"params": jax.tree.map(np.asarray, jstate.params)})
    task = SegmentationTask(model=model, loss="DICE")
    return jtask, jstate, task, create_train_state(model, learning_rate=1e-3, seed=0)


@pytest.mark.parametrize("packed", [False, True])
def test_train_step_loss_and_gradients_match_jax(packed):
    jtask, jstate, task, state = _setup(packed)
    data, label = _batch()
    jbatch = {"data": jnp.asarray(data), "label": jnp.asarray(label)}

    def loss_of(params):
        out = jtask.model.apply({"params": params}, jbatch["data"], train=True)
        return jtask.loss_fn(out, jbatch)[0]

    grads = state_dict_from_jax({"params": jax.tree.map(
        np.asarray, jax.jit(jax.grad(loss_of))(jstate.params))})
    _, metrics = jax_make_train_step(jtask, augment=None)(jstate, jbatch)

    state, got = make_train_step(task)(state, _port_batch(data, label))
    assert state.step == 1 and got["train_loss"].dim() == 0
    assert abs(float(got["train_loss"]) - float(metrics["train_loss"])) <= 1e-5
    named = dict(task.model.named_parameters())
    assert sorted(named) == sorted(grads)
    for k, g_ref in grads.items():
        g = named[k].grad
        scale = float(g_ref.abs().max())
        assert scale > 0, k
        assert float((g - g_ref).abs().max()) <= 1e-4 * scale, k


def test_adam_matches_optax_over_three_steps():
    rng = np.random.default_rng(1)
    shapes = {"w": (4, 3, 3), "b": (5,)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(3)]
    tx = optax.adam(1e-3)
    jp = jax.tree.map(jnp.asarray, params)
    opt_state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = torch.optim.Adam(list(tp.values()), lr=1e-3)
    for g in grads:
        updates, opt_state = tx.update(jax.tree.map(jnp.asarray, g), opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        for k in shapes:
            np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), rtol=1e-6,
                                       atol=1e-8)


def test_step_with_default_augment_moves_parameters():
    _, _, task, state = _setup()
    before = {k: p.detach().clone() for k, p in task.model.named_parameters()}
    step = make_train_step(task, augment=AugmentConfig(mirror_axes=(1, 2, 3)))
    for seed in range(2):
        state, metrics = step(state, _port_batch(*_batch(seed)))
        assert bool(torch.isfinite(metrics["train_loss"]))
    assert state.step == 2
    moved = [k for k, p in task.model.named_parameters() if not torch.equal(p, before[k])]
    assert sorted(moved) == sorted(before)


def test_eval_step_matches_jax():
    jtask, jstate, task, state = _setup()
    data, label = _batch(2)
    ref = jax_make_eval_step(jtask)(jstate, {"data": jnp.asarray(data),
                                             "label": jnp.asarray(label)})
    got = make_eval_step(task)(state, _port_batch(data, label))
    assert sorted(got) == sorted(ref) == ["val_dice0", "val_dice1", "val_loss"]
    for k in ref:
        assert abs(float(got[k]) - float(ref[k])) <= 1e-5, k


def test_train_state_and_unported_options():
    _, jstate, task, state = _setup()
    assert param_count(state) == sum(int(np.prod(p.shape))
                                     for p in jax.tree.leaves(jstate.params))
    assert isinstance(state.optimizer, torch.optim.Adam)
    assert state.generator.device == torch.device("cpu")
    for kw in (dict(ema_decay=0.99), dict(guard_nonfinite=True), dict(track_grad_norm=True)):
        with pytest.raises(NotImplementedError):
            make_train_step(task, **kw)
    # the step trains the state's model; the task only gives the loss
    other = create_train_state(ResidualUNet3D(1, 2, f_maps=4, num_levels=2,
                                              dtype=torch.float32, device="cpu"), 1e-3)
    before = [p.detach().clone() for p in task.model.parameters()]
    other, _ = make_train_step(task)(other, _port_batch(*_batch()))
    assert other.step == 1
    assert all(p.grad is not None for p in other.model.parameters())
    assert all(torch.equal(p, b) for p, b in zip(task.model.parameters(), before))
