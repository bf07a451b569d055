"""The port's optimizer chain against the JAX package's ``OptimizerConfig``.

- every schedule's LR at counts 0..N against ``make_schedule`` (optax),
  rtol 1e-6 with atol 1e-7 * lr (optax evaluates it in float32, whose
  resolution at the LR's scale that is);
- adam, adamw, sgd (momentum, nesterov, coupled weight decay), clipping,
  accumulation k = 3 and plateau: the same seeded gradients go through the
  port's ``apply_gradients`` and through ``OptimizerConfig.build()`` for 6
  micro-steps; parameters after each within rtol 1e-6 and atol 1e-5 * lr
  (the training step's Adam tolerance: the same update rounded in another
  order).  The optax chain runs in float64 on the same float32 inputs:
  in float32 it computes Adam's bias correction ``1 - b2**t`` with a
  cancellation that alone moves an update by up to 1.3e-5 * lr at t = 1,
  which torch's double-precision bias correction does not share;
- ``signature`` and ``check_resume_optimizer`` refuse the same pairs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from tpu_mednet.train import optim as jax_optim
from tpu_mednet_torch.train import optim
from tpu_mednet_torch.train.state import create_train_state
from tpu_mednet_torch.train.step import apply_gradients

SHAPES = {"w": (4, 3, 3), "b": (5,)}


@pytest.mark.parametrize("kw", [
    dict(schedule="constant"),
    dict(schedule="constant", warmup_steps=4),
    dict(schedule="cosine", total_steps=20),
    dict(schedule="cosine", total_steps=20, warmup_steps=5, end_lr_factor=0.1),
    dict(schedule="linear", total_steps=16, end_lr_factor=0.2),
    dict(schedule="linear", total_steps=16, warmup_steps=3),
    dict(schedule="poly", total_steps=18, poly_power=0.9),
    dict(schedule="poly", total_steps=18, warmup_steps=2, end_lr_factor=0.05, poly_power=2.0),
    dict(schedule="step", lr_decay_every=4, lr_decay_rate=0.5),
    dict(schedule="step", lr_decay_every=3, warmup_steps=3),
    dict(schedule="plateau"),
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_schedule_equals_optax(kw):
    port = optim.OptimizerConfig(learning_rate=3e-3, **kw).make_schedule()
    ref = jax_optim.OptimizerConfig(learning_rate=3e-3, **kw).make_schedule()
    counts = range(26)
    got = np.array([port(c) for c in counts])
    want = np.array([float(ref(c)) for c in counts])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7 * 3e-3)
    cfg = optim.OptimizerConfig(learning_rate=3e-3, accumulate_grad_batches=2, **kw)
    jcfg = jax_optim.OptimizerConfig(learning_rate=3e-3, accumulate_grad_batches=2, **kw)
    for step in (0, 1, 5, 11):
        assert cfg.lr_at(step) == pytest.approx(jcfg.lr_at(step), rel=1e-6, abs=3e-10)


class Params(nn.Module):
    def __init__(self, values):
        super().__init__()
        for k, v in values.items():
            self.register_parameter(k, nn.Parameter(torch.from_numpy(v.copy())))


def _run(kw, n_steps=6, grad_scale=1.0, plateau_values=None):
    rng = np.random.default_rng(7)
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: (grad_scale * rng.normal(size=s)).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(n_steps)]
    cfg = optim.OptimizerConfig(**kw)
    jcfg = jax_optim.OptimizerConfig(**kw)
    with jax.enable_x64(True):
        return _compare(kw, cfg, jcfg, params, grads, plateau_values)


def _compare(kw, cfg, jcfg, params, grads, plateau_values):
    f64 = lambda tree: jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)
    tx = jcfg.build()
    jp = f64(params)
    opt_state = tx.init(jp)
    model = Params(params)
    state = create_train_state(model, optimizer=cfg)
    lr = kw.get("learning_rate", 1e-3)
    port_plateau = optim.PlateauController(cfg) if cfg.schedule == "plateau" else None
    jax_plateau = jax_optim.PlateauController(jcfg) if cfg.schedule == "plateau" else None
    for i, g in enumerate(grads):
        updates, opt_state = tx.update(f64(g), opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in model.named_parameters():
            p.grad = torch.from_numpy(g[k].copy())
        apply_gradients(state)
        for k, p in model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), rtol=1e-6,
                                       atol=1e-5 * lr, err_msg=f"{kw} step {i} {k}")
        if port_plateau is not None:
            new = port_plateau.update(state.optimizer, plateau_values[i])
            opt_state, jnew = jax_plateau.update(opt_state, plateau_values[i])
            assert (new is None) == (jnew is None)
            assert optim.read_current_lr(cfg, state.optimizer, state.step) == pytest.approx(
                jax_optim.read_current_lr(jcfg, opt_state, i + 1), rel=1e-7)
    return state


@pytest.mark.parametrize("kw", [
    dict(name="adam"),
    dict(name="adam", beta1=0.8, beta2=0.99, eps=1e-6, learning_rate=1e-2),
    dict(name="adamw", weight_decay=1e-2),
    dict(name="adamw", weight_decay=0.1, schedule="cosine", total_steps=6, warmup_steps=2),
    dict(name="sgd", learning_rate=0.05),
    dict(name="sgd", learning_rate=0.05, nesterov=True),
    dict(name="sgd", learning_rate=0.05, momentum=0.0),
    dict(name="sgd", learning_rate=0.05, weight_decay=1e-3, schedule="step",
         lr_decay_every=2, lr_decay_rate=0.5),
    dict(name="adam", grad_clip_norm=1.0),
    dict(name="sgd", learning_rate=0.05, grad_clip_norm=2.0, nesterov=True),
    dict(name="adam", grad_clip_norm=100.0),
    dict(name="adam", accumulate_grad_batches=3),
    dict(name="sgd", learning_rate=0.05, accumulate_grad_batches=3, grad_clip_norm=1.0,
         schedule="linear", total_steps=2),
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_updates_equal_optax(kw):
    state = _run(kw)
    k = kw.get("accumulate_grad_batches", 1)
    assert state.step == 6 and state.updates == 6 // k and state.mini_step == 0


@pytest.mark.parametrize("name", ["adam", "sgd"])
def test_plateau_equals_optax(name):
    kw = dict(name=name, learning_rate=0.05, schedule="plateau", lr_plateau_patience=2,
              lr_plateau_factor=0.5, min_lr=0.01)
    values = [1.0, 1.0, 1.0, 0.5, 0.5, 0.5]
    state = _run(kw, plateau_values=values)
    # decayed twice: 0.05 -> 0.025 -> 0.0125, never below min_lr
    assert state.optimizer.param_groups[0]["lr"] == pytest.approx(0.0125)


def test_clip_is_optax_rule_not_clip_grad_norm():
    g = [torch.full((4,), 0.5), torch.full((3,), 0.5)]  # norm sqrt(7) / 2
    norm = float(optim.global_norm(g))
    assert norm == pytest.approx(np.sqrt(7) / 2)
    below = [t.clone() for t in g]
    optim.clip_by_global_norm_(below, norm * 1.01)
    assert all(torch.equal(a, b) for a, b in zip(below, g))  # untouched: no 1e-6 shrink
    clipped = [t.clone() for t in g]
    optim.clip_by_global_norm_(clipped, 1.0)
    ref = optax.clip_by_global_norm(1.0).update([jnp.asarray(t.numpy()) for t in g], None)[0]
    for a, b in zip(clipped, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


PAIRS = [
    ({}, dict()),
    ({}, dict(name="adamw")),
    ({"optimizer": "adam"}, dict(grad_clip_norm=1.0)),
    ({"optimizer": "adam", "grad_clip_norm": 1.0}, dict(grad_clip_norm=0.5)),
    ({"optimizer": "sgd", "momentum": 0.9}, dict(name="sgd", momentum=0.0)),
    ({"optimizer": "sgd", "weight_decay": 0.1}, dict(name="sgd")),
    ({"lr_schedule": "cosine", "warmup_steps": 0}, dict(schedule="cosine", total_steps=5)),
    ({"lr_schedule": "constant", "warmup_steps": 3}, dict()),
    ({"ema_decay": 0.99}, dict()),
    ({"ema_decay": 0.99}, dict(ema_decay=0.9)),
    ({"accumulate_grad_batches": 2}, dict(accumulate_grad_batches=3)),
    ({"lr_schedule": "plateau"}, dict(schedule="plateau")),
    ({"lr_schedule": "step", "lr_decay_every": 3}, dict(schedule="step", lr_decay_every=9)),
]


@pytest.mark.parametrize("hp_prev,kw", PAIRS)
def test_resume_refuses_what_jax_refuses(hp_prev, kw):
    def refused(module):
        try:
            module.check_resume_optimizer(hp_prev, module.OptimizerConfig(**kw), "/ckpt")
        except ValueError:
            return True
        return False

    assert optim.OptimizerConfig(**kw).signature() == \
        jax_optim.OptimizerConfig(**kw).signature()
    assert refused(optim) == refused(jax_optim)


@pytest.mark.parametrize("kw", [
    dict(name="nadam"), dict(schedule="exp"), dict(schedule="step"),
    dict(accumulate_grad_batches=0), dict(ema_decay=1.5),
    dict(schedule="plateau", warmup_steps=2), dict(schedule="plateau", lr_plateau_factor=1.0),
    dict(name="adam", weight_decay=0.1),
])
def test_config_refuses_what_jax_refuses(kw):
    with pytest.raises(ValueError):
        jax_optim.OptimizerConfig(**kw)
    with pytest.raises(ValueError):
        optim.OptimizerConfig(**kw)


def test_from_hparams_and_total_steps():
    hp = {"optimizer": "adamw", "lr_schedule": "cosine", "learning_rate": 0.01,
          "weight_decay": 0.1, "accumulate_grad_batches": 2, "seed": 3, "eps": None}
    cfg = optim.OptimizerConfig.from_hparams(hp)
    assert cfg == optim.OptimizerConfig(name="adamw", schedule="cosine", learning_rate=0.01,
                                        weight_decay=0.1, accumulate_grad_batches=2)
    assert cfg.resolve_total_steps(21).total_steps == 10
    assert isinstance(cfg.resolve_total_steps(21).build([nn.Parameter(torch.ones(2))]),
                      torch.optim.AdamW)
