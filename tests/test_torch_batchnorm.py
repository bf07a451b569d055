"""BatchNorm orders of the port against the JAX package's, on the CPU.

``ConvLayer`` in the four orders of the torch reference's configs (``cbr``,
``gcr``, ``crg``, ``cgr``) in train and eval mode, the BatchNorm module's
running update against flax's, and ``UNet3D(1, 3, f_maps=8,
num_levels=3, layer_order="cbr")`` in fp32 through the train step, remat,
gradient accumulation, the non-finite guard, the EMA eval step, a
checkpoint and ``Trainer.fit``.  The JAX package draws the weights and its
``batch_stats``; ``load_jax_params`` carries both into the port.

Tolerances: a ``ConvLayer``'s output atol 1e-5 (one conv and one
normalization, summed in another order).  Running statistics rtol 1e-5,
atol 1e-6: flax takes the batch variance as E[x^2] - E[x]^2 in fp32, the
port's ``F.batch_norm`` sums (x - mean)^2, so the two differ by the
rounding of the mean's square; over three steps the parameters they
normalize moved by the optimizer's own rounding (SGD with momentum:
Adam would turn summation-order noise in a near-zero gradient into a full
step, ``test_torch_trainer.py``).
The train step's loss atol 1e-5 and gradients within 1e-4 * max |g| of
their leaf (of the model where a leaf's own max is below 1e-3 of it), eval
metrics atol 1e-5, the Trainer's as in ``test_torch_trainer.py``.  The
port against itself (remat, checkpoints): bit-equal.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from tpu_mednet.data import MemoryReader as JaxMemoryReader
from tpu_mednet.data import PatchSampler as JaxPatchSampler
from tpu_mednet.models import UNet3DBase, UNetConfig
from tpu_mednet.models.blocks import ConvLayer as JaxConvLayer
from tpu_mednet.tasks import SegmentationTask as JaxSegmentationTask
from tpu_mednet.train import OptimizerConfig as JaxOptimizerConfig
from tpu_mednet.train import Trainer as JaxTrainer
from tpu_mednet.train import create_train_state as jax_create_train_state
from tpu_mednet.train import make_eval_step as jax_make_eval_step
from tpu_mednet.train import make_train_step as jax_make_train_step
from tpu_mednet_torch.data import MemoryReader, PatchSampler
from tpu_mednet_torch.models import UNet3D, blocks
from tpu_mednet_torch.tasks import SegmentationTask
from tpu_mednet_torch.train import (CheckpointManager, OptimizerConfig, Trainer,
                                    create_train_state, load_for_inference, make_eval_step,
                                    make_train_step)
from tpu_mednet_torch.utils.weights import load_jax_params, state_dict_from_jax

CL3D = torch.channels_last_3d
BATCH_SHAPE = (2, 16, 16, 16, 1)
STATS_TOL = dict(rtol=1e-5, atol=1e-6)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _to_port(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a).permute(0, 4, 1, 2, 3).contiguous(memory_format=CL3D)


def _conv_layer_state(params, stats):
    """A JAX ConvLayer's variables as the port ConvLayer's state dict."""
    sd = {"conv.weight": torch.from_numpy(
        np.asarray(params["conv"]["kernel"]).transpose(4, 3, 0, 1, 2).copy())}
    if "bias" in params["conv"]:
        sd["conv.bias"] = torch.from_numpy(np.asarray(params["conv"]["bias"]).copy())
    for norm in ("groupnorm", "batchnorm"):
        if norm in params:
            sd[f"{norm}.weight"] = torch.from_numpy(np.asarray(params[norm]["scale"]).copy())
            sd[f"{norm}.bias"] = torch.from_numpy(np.asarray(params[norm]["bias"]).copy())
    if stats:
        bn = stats["batchnorm"]
        sd["batchnorm.running_mean"] = torch.from_numpy(np.asarray(bn["mean"]).copy())
        sd["batchnorm.running_var"] = torch.from_numpy(np.asarray(bn["var"]).copy())
        sd["batchnorm.num_batches_tracked"] = torch.tensor(0)
    return sd


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("order", ["cbr", "gcr", "crg", "cgr"])
def test_conv_layer_matches_jax(order, train):
    rng = np.random.default_rng(2)
    x = (rng.normal(size=(2, 6, 7, 5, 8)) + 0.3).astype(np.float32)
    ref_mod = JaxConvLayer(out_channels=16, order=order, num_groups=4)
    v = _np_tree(ref_mod.init(jax.random.PRNGKey(1), jnp.asarray(x), train=False))
    if "batch_stats" in v:  # running statistics away from their init
        bn = v["batch_stats"]["batchnorm"]
        bn["mean"] = rng.normal(size=bn["mean"].shape).astype(np.float32)
        bn["var"] = rng.uniform(0.5, 2.0, size=bn["var"].shape).astype(np.float32)
    if train and "batch_stats" in v:
        ref, mutated = ref_mod.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
        want_stats = _np_tree(mutated["batch_stats"])
    else:
        ref, want_stats = ref_mod.apply(v, jnp.asarray(x), train=train), None

    port = blocks.ConvLayer(8, 16, order=order, num_groups=4, device="cpu")
    port.load_state_dict(_conv_layer_state(v["params"], v.get("batch_stats")), strict=True)
    port.train(train)
    with torch.no_grad():
        y = port(_to_port(x))
    np.testing.assert_allclose(y.permute(0, 2, 3, 4, 1).numpy(), np.asarray(ref), atol=1e-5)
    if want_stats is not None:
        bn = port.batchnorm
        np.testing.assert_allclose(bn.running_mean.numpy(), want_stats["batchnorm"]["mean"],
                                   **STATS_TOL)
        np.testing.assert_allclose(bn.running_var.numpy(), want_stats["batchnorm"]["var"],
                                   **STATS_TOL)
    elif "b" in order:  # eval mode leaves them alone
        assert torch.equal(port.batchnorm.running_mean,
                           torch.from_numpy(v["batch_stats"]["batchnorm"]["mean"]))


def test_running_update_is_flax_not_batchnorm3d():
    """Three training-mode calls: the port's running statistics follow
    flax's (biased variance, 0.9 on the old value); torch's own
    ``nn.BatchNorm3d`` (unbiased variance) drifts from them."""
    rng = np.random.default_rng(3)
    xs = [(rng.normal(size=(2, 3, 4, 5, 6)) * 2 + 1).astype(np.float32) for _ in range(3)]
    flax_bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = flax_bn.init(jax.random.PRNGKey(0), jnp.asarray(xs[0]))
    port = blocks.BatchNorm(6)
    torch_bn = torch.nn.BatchNorm3d(6, momentum=0.1)
    for x in xs:
        _, mutated = flax_bn.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
        variables = {**variables, **mutated}
        port(_to_port(x))
        torch_bn(_to_port(x))
    stats = _np_tree(variables["batch_stats"])
    np.testing.assert_allclose(port.running_mean.numpy(), stats["mean"], **STATS_TOL)
    np.testing.assert_allclose(port.running_var.numpy(), stats["var"], **STATS_TOL)
    assert not np.allclose(torch_bn.running_var.numpy(), stats["var"], **STATS_TOL)
    assert int(port.num_batches_tracked) == 0


def test_loaded_batch_count_is_dropped():
    """``num_batches_tracked`` loads strictly and stays 0, as the JAX
    package's import drops it (flax keeps no count)."""
    port = blocks.BatchNorm(4)
    sd = {k: v.clone() for k, v in port.state_dict().items()}
    sd["num_batches_tracked"] = torch.tensor(7)
    sd["running_mean"] = torch.arange(4.0)
    port.load_state_dict(sd, strict=True)
    assert int(port.num_batches_tracked) == 0
    assert torch.equal(port.running_mean, torch.arange(4.0))


# -- UNet3D cbr through the train step -------------------------------------------

def _batches(n=3, nan_at=None):
    rng = np.random.default_rng(4)
    out = []
    for i in range(n):
        label = np.zeros(BATCH_SHAPE, np.uint8)
        label[:, 4:12, 3:11, 5:13] = 1 + (i % 2)
        data = (rng.normal(size=BATCH_SHAPE) + 1.5 * (label > 0)).astype(np.float32)
        if i == nan_at:
            data[0, 0, 0, 0, 0] = np.nan
        out.append((data, label))
    return out


# SGD with momentum, as test_torch_trainer.py: Adam turns fp32
# summation-order noise in a near-zero gradient into a full +-lr step
SGD = dict(name="sgd", learning_rate=0.05, momentum=0.9)


def _setup(order="cbr", remat=False, optim=None, ema=False):
    """(JAX task, JAX state, port task, port state) from the same weights
    and batch statistics, SGD with momentum and ``optim``'s options."""
    optim = {**SGD, **(optim or {})}
    cfg = UNetConfig(in_channels=1, out_channels=3, f_maps=8, num_levels=3, block="double",
                     layer_order=order, dtype=jnp.float32, remat=remat)
    jtask = JaxSegmentationTask(model=UNet3DBase(config=cfg), loss="DICE")
    jcfg = JaxOptimizerConfig(**optim)
    jstate = jax_create_train_state(jtask.model, BATCH_SHAPE, learning_rate=1e-3, seed=0,
                                    optimizer=jcfg.build(), ema=ema)
    model = UNet3D(1, 3, f_maps=8, num_levels=3, layer_order=order, dtype=torch.float32,
                   device="cpu")
    model.config = dataclasses.replace(model.config, remat=remat)
    variables = {"params": _np_tree(jstate.params)}
    if jstate.batch_stats is not None:
        variables["batch_stats"] = _np_tree(jstate.batch_stats)
    load_jax_params(model, variables)
    state = create_train_state(model, optimizer=OptimizerConfig(**optim), seed=0)
    return jtask, jstate, SegmentationTask(model=model, loss="DICE"), state


def _assert_stats_equal_jax(model, jstate):
    want = state_dict_from_jax({"params": _np_tree(jstate.params),
                                "batch_stats": _np_tree(jstate.batch_stats)})
    got = model.state_dict()
    keys = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert len(keys) == 2 * 10  # 10 BatchNorms: 2 per DoubleConv, 5 blocks
    for k in keys:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), err_msg=k, **STATS_TOL)
    assert all(int(got[k]) == 0 for k in got if k.endswith("num_batches_tracked"))


@pytest.mark.parametrize("order", ["cbr", "gcr"])
def test_train_step_loss_and_gradients_match_jax(order):
    jtask, jstate, task, state = _setup(order)
    data, label = _batches(1)[0]
    jbatch = {"data": jnp.asarray(data), "label": jnp.asarray(label)}

    def loss_of(params):
        variables = {"params": params}
        if jstate.batch_stats is not None:
            variables["batch_stats"] = jstate.batch_stats
            out, _ = jtask.model.apply(variables, jbatch["data"], train=True,
                                       mutable=["batch_stats"])
        else:
            out = jtask.model.apply(variables, jbatch["data"], train=True)
        return jtask.loss_fn(out, jbatch)[0]

    loss, grads = jax.jit(jax.value_and_grad(loss_of))(jstate.params)
    grads = state_dict_from_jax({"params": _np_tree(grads)} | (
        {"batch_stats": _np_tree(jstate.batch_stats)} if jstate.batch_stats else {}))
    state, got = make_train_step(task)(state, {"data": _to_port(data), "label": _to_port(label)})
    assert abs(float(got["train_loss"]) - float(loss)) <= 1e-5
    named = dict(task.model.named_parameters())
    assert set(named) <= set(grads)
    top = max(float(grads[k].abs().max()) for k in named)
    for k, p in named.items():
        # a leaf whose gradient is a cancelling sum (gcr's input GroupNorm,
        # one channel in one group: ~1e-8 against ~1e-2 elsewhere) is held
        # to 1e-4 * the model's max |g|, every other leaf to its own
        scale = max(float(grads[k].abs().max()), 1e-3 * top)
        assert float((p.grad - grads[k]).abs().max()) <= 1e-4 * scale, k


# (remat, optimizer config, step options, batch that is non-finite)
_STEP_CASES = {
    "plain": (False, {}, {}, None),
    "remat1": (1, {}, {}, None),
    "remat_all": (True, {}, {}, None),
    # three micro-steps of one update: the statistics move three times
    "accumulate3": (False, {"accumulate_grad_batches": 3}, {}, None),
    "guard_skip": (False, {}, {"guard_nonfinite": True}, 1),
}


@pytest.mark.parametrize("case", list(_STEP_CASES))
def test_running_stats_after_train_steps_match_jax(case):
    """Three steps of ``make_train_step`` on both packages: losses and the
    running statistics (JAX's ``batch_stats``).  Remat moves them once a
    step, accumulation on every micro-step, a skipped step not at all."""
    remat, optim, opts, nan_at = _STEP_CASES[case]
    jtask, jstate, task, state = _setup(remat=remat, optim=optim)
    jstep = jax_make_train_step(jtask, augment=None, **opts)
    step = make_train_step(task, **opts)
    for i, (data, label) in enumerate(_batches(3, nan_at)):
        before = [t.clone() for t in blocks.batch_stat_buffers(task.model)]
        jstate, jm = jstep(jstate, {"data": jnp.asarray(data), "label": jnp.asarray(label)})
        state, m = step(state, {"data": _to_port(data), "label": _to_port(label)})
        if i == nan_at:
            assert float(m["nonfinite"]) == float(jm["nonfinite"]) == 1.0
            after = blocks.batch_stat_buffers(task.model)
            assert all(torch.equal(a, b) for a, b in zip(before, after))
        else:
            assert abs(float(m["train_loss"]) - float(jm["train_loss"])) <= 1e-5, i
    assert state.step == int(jstate.step)
    _assert_stats_equal_jax(task.model, jstate)


def test_remat_moves_running_stats_once():
    """Remat 1 and all leave the running statistics bit-equal to remat 0
    after the same steps: the backward's recompute does not move them."""
    got = {}
    for remat in (False, 1, True):
        model = UNet3D(1, 3, f_maps=8, num_levels=3, layer_order="cbr", dtype=torch.float32,
                       device="cpu", generator=torch.Generator().manual_seed(0))
        model.config = dataclasses.replace(model.config, remat=remat)
        state = create_train_state(model, seed=0)
        step = make_train_step(SegmentationTask(model=model, loss="DICE"))
        for data, label in _batches(2):
            state, _ = step(state, {"data": _to_port(data), "label": _to_port(label)})
        got[remat] = [t.clone() for t in blocks.batch_stat_buffers(model)]
    for remat in (1, True):
        assert all(torch.equal(a, b) for a, b in zip(got[False], got[remat])), remat
    assert not torch.equal(got[False][0], torch.zeros_like(got[False][0]))


def test_ema_eval_step_matches_jax():
    """``make_eval_step(use_ema=True)`` runs the EMA parameters with the
    model's running statistics, as JAX's runs ``ema_params`` with
    ``batch_stats``."""
    jtask, jstate, task, state = _setup(optim={"ema_decay": 0.9}, ema=True)
    jstep = jax_make_train_step(jtask, augment=None, ema_decay=0.9)
    step = make_train_step(task, ema_decay=0.9)
    batches = _batches(3)
    for data, label in batches[:2]:
        jstate, _ = jstep(jstate, {"data": jnp.asarray(data), "label": jnp.asarray(label)})
        state, _ = step(state, {"data": _to_port(data), "label": _to_port(label)})
    assert sorted(state.ema) == sorted(k for k, _ in task.model.named_parameters())
    data, label = batches[2]
    for use_ema in (True, False):
        want = jax_make_eval_step(jtask, use_ema=use_ema)(
            jstate, {"data": jnp.asarray(data), "label": jnp.asarray(label)})
        got = make_eval_step(task, use_ema=use_ema)(
            state, {"data": _to_port(data), "label": _to_port(label)})
        assert sorted(got) == sorted(want)
        for k in want:
            assert abs(float(got[k]) - float(want[k])) <= 1e-5, (use_ema, k)


def test_checkpoint_round_trip_carries_running_stats(tmp_path):
    """``save`` -> ``restore`` (the ``--resume`` path) and
    ``load_for_inference`` carry the running statistics bit for bit, the
    EMA weights with them."""
    _, _, task, state = _setup(optim={"ema_decay": 0.9})
    step = make_train_step(task, ema_decay=0.9)
    for data, label in _batches(2):
        state, _ = step(state, {"data": _to_port(data), "label": _to_port(label)})
    CheckpointManager(tmp_path / "ckpt").save(state.step, state, hparams={"fmaps": 8})
    _, _, task2, fresh = _setup(optim={"ema_decay": 0.9})
    restored, _ = CheckpointManager(tmp_path / "ckpt").restore(fresh)
    want = task.model.state_dict()
    got = restored.model.state_dict()
    assert sorted(got) == sorted(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert all(torch.equal(restored.ema[k], state.ema[k]) for k in state.ema)
    for use_ema in (True, False):
        sd, _ = load_for_inference(tmp_path / "ckpt", use_ema=use_ema)
        model = UNet3D(1, 3, f_maps=8, num_levels=3, layer_order="cbr", dtype=torch.float32,
                       device="cpu")
        model.load_state_dict(sd, strict=True)
        for k in [k for k in want if "running" in k]:
            assert torch.equal(model.state_dict()[k], want[k]), k
        params = state.ema if use_ema else dict(task.model.named_parameters())
        for k, p in model.named_parameters():
            assert torch.equal(p, params[k]), k


PATCH = (16, 16, 16)
TRAIN_SHAPES = {"s0": (20, 18, 22), "s1": (18, 20, 16), "s2": (22, 16, 18)}
VAL_SHAPES = {"v0": (18, 18, 20)}


def _store(shapes, seed=0):
    rng = np.random.default_rng(seed)
    store = {"images": {}, "labels": {}}
    for key, shape in shapes.items():
        lbl = np.zeros((1, *shape), np.uint8)
        lbl[0, 3:11, 4:12, 2:10] = 1
        lbl[0, 12:16, 4:12, 2:10] = 2
        store["images"][key] = (rng.normal(size=(1, *shape)) + 2 * lbl).astype(np.float32)
        store["labels"][key] = lbl
    return store


def test_trainer_fit_matches_jax_and_resumes_bit_for_bit(tmp_path):
    """``Trainer.fit`` of ``SegmentationTask(model=UNet3D(..., "cbr"))``
    from Python on both packages (SGD with momentum and EMA, 2 epochs of 3
    steps, validation each epoch): losses, validation means, parameters,
    EMA and running statistics; then the port resumed from its step-3
    checkpoint to step 6 equals the straight run bit for bit."""
    store = _store(TRAIN_SHAPES)
    val_store = _store(VAL_SHAPES, seed=1)
    store = {g: {**store[g], **val_store[g]} for g in store}
    keys, val_keys = list(TRAIN_SHAPES), list(VAL_SHAPES)
    opt = dict(name="sgd", learning_rate=0.05, momentum=0.9, ema_decay=0.9)
    common = dict(batch_size=2, max_epochs=2, learning_rate=0.05, seed=0, log_every=1,
                  keep_checkpoints=3, hparams={"fmaps": [8, 16, 32], "optimizer": "sgd",
                                               "momentum": 0.9, "ema_decay": 0.9})
    sampler_kw = dict(patch_size=PATCH, seed=0, class_probabilities=[0.4, 0.3, 0.3])

    cfg = UNetConfig(in_channels=1, out_channels=3, f_maps=8, num_levels=3, block="double",
                     layer_order="cbr", dtype=jnp.float32)
    jtask = JaxSegmentationTask(model=UNet3DBase(config=cfg), loss="DICE")
    jtrainer = JaxTrainer(
        jtask, JaxPatchSampler(None, keys, 2, reader=JaxMemoryReader(store), **sampler_kw),
        val_sampler=JaxPatchSampler(None, val_keys, 2, reader=JaxMemoryReader(store),
                                    patch_size=PATCH, seed=1),
        model_dir=str(tmp_path / "jax"), log_dir=str(tmp_path / "jax_logs"),
        native_loader=False, optim=JaxOptimizerConfig(**opt), **common)
    jtrainer.fit()
    init = jax_create_train_state(jtask.model, (2, *PATCH, 1), 0.05, seed=0)

    def port_trainer(name, max_epochs, store=store, keys=keys, val_keys=val_keys):
        model = UNet3D(1, 3, f_maps=8, num_levels=3, layer_order="cbr", dtype=torch.float32,
                       device="cpu")
        load_jax_params(model, {"params": _np_tree(init.params),
                                "batch_stats": _np_tree(init.batch_stats)})
        return Trainer(
            SegmentationTask(model=model, loss="DICE"),
            PatchSampler(None, keys, 2, reader=MemoryReader(store), **sampler_kw),
            val_sampler=PatchSampler(None, val_keys, 2, reader=MemoryReader(store),
                                     patch_size=PATCH, seed=1),
            model_dir=str(tmp_path / name), log_dir=str(tmp_path / f"{name}_logs"),
            optim=OptimizerConfig(**opt), **{**common, "max_epochs": max_epochs})

    trainer = port_trainer("port", 2)
    state = trainer.fit()
    assert state.step == int(jtrainer.state.step) == 6

    def by_key(path, key):
        recs = [json.loads(line) for line in (path / "metrics.jsonl").read_text().splitlines()]
        return {r["step"]: r[key] for r in recs if key in r}

    for key in ("train_loss", "val_loss", "val_dice0", "val_dice1", "val_dice2"):
        want = by_key(tmp_path / "jax_logs", key)
        got = by_key(tmp_path / "port_logs", key)
        assert sorted(got) == sorted(want) and want, key
        for s in want:
            assert abs(got[s] - want[s]) <= 1e-5, (key, s)
    model = trainer.task.model
    for ours, theirs in ((dict(model.named_parameters()), jtrainer.state.params),
                         (state.ema, jtrainer.state.ema_params)):
        ref = state_dict_from_jax({"params": _np_tree(theirs),
                                   "batch_stats": _np_tree(jtrainer.state.batch_stats)})
        for k in ours:
            scale = float(ref[k].abs().max())
            assert float((ours[k].detach() - ref[k]).abs().max()) <= 1e-4 * scale, k
    _assert_stats_equal_jax(model, jtrainer.state)

    # the resume, on volumes of the patch size: every epoch draws the same batches
    fixed = _store({"f0": PATCH, "f1": PATCH})
    fixed = {g: {**fixed[g], "v0": val_store[g]["v0"]} for g in fixed}
    kw = dict(store=fixed, keys=["f0", "f1"], val_keys=["v0"])
    straight = port_trainer("straight", 2, **kw).fit()
    port_trainer("resumed", 1, **kw).fit()
    resumed = port_trainer("resumed", 2, **kw).fit(resume=str(tmp_path / "resumed"))
    assert straight.step == resumed.step == 4
    a, b = straight.model.state_dict(), resumed.model.state_dict()
    assert sorted(a) == sorted(b) and any("running_var" in k for k in a)
    assert all(torch.equal(a[k], b[k]) for k in a)
