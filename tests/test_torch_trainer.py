"""The port's Trainer against the JAX package's, and its own controls, on the CPU.

Against JAX: ``Trainer.fit`` of both packages on a tiny
``ResidualUNet3D(1, 2, f_maps=4, num_levels=3)`` in fp32 with 16³ patches,
no augmentation, SGD with momentum, gradient clipping and EMA, 3 epochs of
3 steps.  The JAX Trainer draws the initial weights and ``load_jax_params``
carries them into the port; both host ``PatchSampler``s draw byte-equal
batches from one seed (``native_loader=False`` on the JAX side: its C++
pipeline gives the same batches).  SGD rather than Adam, because Adam
turns fp32 summation-order noise in a near-zero gradient into a full ±lr
step (Adam is held exactly by ``test_torch_optim.py``).  Tolerances:
per-step losses atol 1e-5, final parameters and EMA per tensor within
1e-4 * max |p|, validation means atol 1e-5 (the train step's own
tolerances, carried over nine steps); the same retained steps and best/.

The port alone: 4 steps straight equal 2 steps, a resume and 2 steps, bit
for bit (optimizer, schedule, accumulation, EMA and the augmentation
generator all restored); the non-finite policies on a NaN subject; early
stopping; a plateau decay kept across a resume.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_mednet.data import MemoryReader as JaxMemoryReader
from tpu_mednet.data import PatchSampler as JaxPatchSampler
from tpu_mednet.models import UNet3DBase, UNetConfig
from tpu_mednet.tasks import SegmentationTask as JaxSegmentationTask
from tpu_mednet.train import CheckpointManager as JaxCheckpointManager
from tpu_mednet.train import OptimizerConfig as JaxOptimizerConfig
from tpu_mednet.train import Trainer as JaxTrainer
from tpu_mednet.train import create_train_state as jax_create_train_state
from tpu_mednet_torch.data import MemoryReader, PatchSampler
from tpu_mednet_torch.models import ResidualUNet3D
from tpu_mednet_torch.ops.augment import AugmentConfig
from tpu_mednet_torch.tasks import SegmentationTask
from tpu_mednet_torch.train import (CheckpointManager, NonFiniteError, OptimizerConfig,
                                    Trainer)
from tpu_mednet_torch.train.optim import read_current_lr
from tpu_mednet_torch.utils.weights import load_jax_params, state_dict_from_jax

PATCH = (16, 16, 16)
BATCH = 2
TRAIN_SHAPES = {"s0": (20, 18, 22), "s1": (18, 20, 16), "s2": (22, 16, 18)}
VAL_SHAPES = {"v0": (18, 18, 20)}


def _store(shapes, seed=0):
    rng = np.random.default_rng(seed)
    store = {"images": {}, "labels": {}}
    for key, shape in shapes.items():
        lbl = np.zeros((1, *shape), np.uint8)
        lbl[0, 3:11, 4:12, 2:10] = 1
        store["images"][key] = (rng.normal(size=(1, *shape)) + 2 * lbl).astype(np.float32)
        store["labels"][key] = lbl
    return store


def _records(log_dir):
    lines = (log_dir / "metrics.jsonl").read_text().splitlines()
    return [json.loads(line) for line in lines]


def _by_key(records, key):
    return {r["step"]: r[key] for r in records if key in r}


def test_fit_matches_jax_trainer(tmp_path):
    store = {**_store(TRAIN_SHAPES)}
    val_store = _store(VAL_SHAPES, seed=1)
    store = {g: {**store[g], **val_store[g]} for g in store}
    keys, val_keys = list(TRAIN_SHAPES), list(VAL_SHAPES)
    opt = dict(name="sgd", learning_rate=0.05, momentum=0.9, grad_clip_norm=0.5,
               ema_decay=0.9)
    common = dict(batch_size=BATCH, max_epochs=3, learning_rate=0.05, seed=0,
                  log_every=1, keep_checkpoints=2, hparams={"fmaps": 4})
    sampler_kw = dict(patch_size=PATCH, seed=0)

    cfg = UNetConfig(in_channels=1, out_channels=2, f_maps=4, num_levels=3,
                     dtype=jnp.float32)
    jtask = JaxSegmentationTask(model=UNet3DBase(config=cfg), loss="DICE")
    jtrainer = JaxTrainer(
        jtask,
        JaxPatchSampler(None, keys, 2, reader=JaxMemoryReader(store),
                        class_probabilities=[0.5, 0.5], **sampler_kw),
        val_sampler=JaxPatchSampler(None, val_keys, 2, reader=JaxMemoryReader(store),
                                    patch_size=PATCH, seed=1),
        model_dir=str(tmp_path / "jax"), log_dir=str(tmp_path / "jax_logs"),
        native_loader=False, optim=JaxOptimizerConfig(**opt), **common)
    jtrainer.fit()
    init = jax_create_train_state(jtask.model, (BATCH, *PATCH, 1), 0.05, seed=0).params

    model = ResidualUNet3D(1, 2, f_maps=4, num_levels=3, dtype=torch.float32, device="cpu")
    load_jax_params(model, {"params": jax.tree.map(np.asarray, init)})
    trainer = Trainer(
        SegmentationTask(model=model, loss="DICE"),
        PatchSampler(None, keys, 2, reader=MemoryReader(store),
                     class_probabilities=[0.5, 0.5], **sampler_kw),
        val_sampler=PatchSampler(None, val_keys, 2, reader=MemoryReader(store),
                                 patch_size=PATCH, seed=1),
        model_dir=str(tmp_path / "port"), log_dir=str(tmp_path / "port_logs"),
        optim=OptimizerConfig(**opt), **common)
    state = trainer.fit()
    assert state.step == jtrainer.state.step == 9

    got, want = _records(tmp_path / "port_logs"), _records(tmp_path / "jax_logs")
    losses, ref_losses = _by_key(got, "train_loss"), _by_key(want, "train_loss")
    assert sorted(losses) == sorted(ref_losses) == list(range(1, 10))
    for step in ref_losses:
        assert abs(losses[step] - ref_losses[step]) <= 1e-5, step
    for name in ("val_loss", "val_dice0", "val_dice1"):
        ref = _by_key(want, name)
        assert sorted(_by_key(got, name)) == sorted(ref) == [3, 6, 9]
        for step, v in _by_key(got, name).items():
            assert abs(v - ref[step]) <= 1e-5, (name, step)
    assert sorted(_by_key(got, "lr")) == sorted(_by_key(want, "lr"))

    for ours, theirs in ((dict(model.named_parameters()), jtrainer.state.params),
                         (state.ema, jtrainer.state.ema_params)):
        ref = state_dict_from_jax({"params": jax.tree.map(np.asarray, theirs)})
        assert sorted(ours) == sorted(ref)
        for k, r in ref.items():
            scale = float(r.abs().max())
            assert float((ours[k].detach() - r).abs().max()) <= 1e-4 * scale, k

    assert CheckpointManager(tmp_path / "port").available_steps == \
        JaxCheckpointManager(tmp_path / "jax").available_steps == [6, 9]
    assert CheckpointManager(tmp_path / "port" / "best").available_steps == \
        JaxCheckpointManager(tmp_path / "jax" / "best").available_steps


@pytest.mark.parametrize("samples,shuffle", [(3, True), (3, False), (1, True)],
                         ids=["shuffled", "in_order", "short_epoch_padded"])
def test_host_sampler_batches_equal_jax(samples, shuffle):
    # 3 subjects x 3 patches = 9 items in batches of 4 (the trailing one is
    # dropped); 3 x 1 = 3 items < 4: one batch padded by re-drawing
    store = _store(TRAIN_SHAPES)
    kw = dict(patch_size=PATCH, class_probabilities=[0.5, 0.5], seed=3)
    ref = JaxPatchSampler(None, list(TRAIN_SHAPES), samples, reader=JaxMemoryReader(store), **kw)
    port = PatchSampler(None, list(TRAIN_SHAPES), samples, reader=MemoryReader(store), **kw)
    for _ in range(2):  # two epochs: the generator carries over
        want = list(ref.batches(4, shuffle=shuffle))
        got = list(port.batches(4, shuffle=shuffle))
        assert len(got) == len(want) == (2 if samples == 3 else 1)
        for a, b in zip(got, want):
            assert a["data"].is_contiguous(memory_format=torch.channels_last_3d)
            np.testing.assert_array_equal(a["data"].permute(0, 2, 3, 4, 1).numpy(), b["data"])
            np.testing.assert_array_equal(a["label"].permute(0, 2, 3, 4, 1).numpy(), b["label"])
            assert a["subject_key"] == list(b["subject_key"])


def _fixed_samplers(store=None, samples=4):
    """Volumes of exactly the patch size: every batch is the same."""
    store = store or _store({"s": PATCH})
    train = PatchSampler(None, ["s"], samples, PATCH, reader=MemoryReader(store), seed=0)
    val = PatchSampler(None, ["s"], 2, PATCH, reader=MemoryReader(store), seed=1)
    return train, val


def _model(seed=0):
    return ResidualUNet3D(1, 2, f_maps=4, num_levels=3, dtype=torch.float32, device="cpu",
                          generator=torch.Generator().manual_seed(seed))


def _trainer(tmp_path, name, max_epochs, optim, augment=None, seed=0, **kw):
    train, val = _fixed_samplers()
    return Trainer(SegmentationTask(model=_model(seed)), train, val_sampler=val,
                   batch_size=BATCH, max_epochs=max_epochs, model_dir=str(tmp_path / name),
                   log_dir=str(tmp_path / f"{name}_logs"), optim=optim, augment=augment,
                   log_every=1, **kw)


def test_resume_continues_bit_for_bit(tmp_path):
    optim = OptimizerConfig(name="adamw", learning_rate=1e-3, weight_decay=1e-2,
                            schedule="cosine", total_steps=4, warmup_steps=1,
                            grad_clip_norm=1.0, accumulate_grad_batches=2, ema_decay=0.9)
    augment = AugmentConfig(mirror_axes=(1, 2, 3), noise_sigma=0.1)
    straight = _trainer(tmp_path, "a", 2, optim, augment).fit()
    _trainer(tmp_path, "b", 1, optim, augment).fit()
    # a differently initialised model: the restore must overwrite everything
    resumed = _trainer(tmp_path, "b", 2, optim, augment, seed=1).fit(resume=str(tmp_path / "b"))
    assert straight.step == resumed.step == 4 and straight.updates == resumed.updates == 2
    for (k, p), q in zip(straight.model.named_parameters(), resumed.model.parameters()):
        assert torch.equal(p, q), k
        assert torch.equal(straight.ema[k], resumed.ema[k]), k
    for a, b in zip(straight.optimizer.state.values(), resumed.optimizer.state.values()):
        assert all(torch.equal(a[n], b[n]) for n in a)
    assert torch.equal(straight.generator.get_state(), resumed.generator.get_state())
    assert _by_key(_records(tmp_path / "a_logs"), "val_loss")[4] == \
        _by_key(_records(tmp_path / "b_logs"), "val_loss")[4]
    assert CheckpointManager(tmp_path / "b").available_steps == [2, 4]


def test_resume_refuses_another_architecture_or_optimizer(tmp_path):
    optim = OptimizerConfig(name="sgd", learning_rate=1e-3)
    _trainer(tmp_path, "c", 1, optim, hparams={"fmaps": [4, 8, 16], "in_channels": 1,
                                                    "optimizer": "sgd"}).fit()
    with pytest.raises(ValueError, match="optimizer state"):
        _trainer(tmp_path, "c", 2, OptimizerConfig(), hparams={}).fit(
            resume=str(tmp_path / "c"))
    train, val = _fixed_samplers()
    other = Trainer(SegmentationTask(model=ResidualUNet3D(1, 2, f_maps=8, num_levels=3,
                                                          device="cpu")),
                    train, batch_size=BATCH, max_epochs=2, optim=optim)
    with pytest.raises(ValueError, match="different architecture"):
        other.fit(resume=str(tmp_path / "c"))


@pytest.mark.parametrize("policy", ["skip", "terminate"])
def test_nonfinite_policies_on_a_nan_subject(tmp_path, policy):
    store = _store({"good": PATCH, "bad": PATCH})
    store["images"]["bad"][:] = np.nan
    train = PatchSampler(None, ["good", "bad"], 2, PATCH, reader=MemoryReader(store), seed=0)
    trainer = Trainer(SegmentationTask(model=_model()), train, batch_size=1, max_epochs=1,
                      model_dir=str(tmp_path / "m"), log_dir=str(tmp_path / "logs"),
                      optim=OptimizerConfig(name="sgd", learning_rate=0.05), nonfinite=policy,
                      log_every=1)
    if policy == "terminate":
        with pytest.raises(NonFiniteError, match="terminate"):
            trainer.fit()
    else:
        trainer.fit()
    state = trainer.state
    assert state.step == 2  # the two NaN steps were skipped
    assert all(bool(torch.isfinite(p).all()) for p in state.model.parameters())
    records = _records(tmp_path / "logs")
    assert _by_key(records, "nonfinite_steps") == {2: 2.0}
    # a skipped step leaves the step count, so two records share a step
    assert sorted(r["nonfinite"] for r in records if "nonfinite" in r) == [0, 0, 1, 1]
    assert CheckpointManager(tmp_path / "m").available_steps == [2]

    store["images"]["good"][:] = np.nan  # every step non-finite: skip stops too
    train = PatchSampler(None, ["good"], 2, PATCH, reader=MemoryReader(store), seed=0)
    trainer = Trainer(SegmentationTask(model=_model()), train, batch_size=1, max_epochs=1,
                      optim=OptimizerConfig(name="sgd"), nonfinite="skip")
    with pytest.raises(NonFiniteError, match="every step"):
        trainer.fit()


def test_early_stopping(tmp_path):
    # lr 0: the weights and the (fixed) val batches never change, so
    # val_loss never improves after the first check
    trainer = _trainer(tmp_path, "e", 10, OptimizerConfig(name="sgd", learning_rate=0.0),
                       early_stop_patience=2)
    state = trainer.fit()
    assert state.step == 3 * 2  # epochs 0, 1, 2 of two steps
    assert sorted(_by_key(_records(tmp_path / "e_logs"), "val_loss")) == [2, 4, 6]
    assert CheckpointManager(tmp_path / "e").available_steps == [2, 4, 6]
    assert CheckpointManager(tmp_path / "e" / "best").available_steps == [2]


def test_plateau_decay_is_kept_across_resume(tmp_path):
    optim = OptimizerConfig(name="sgd", learning_rate=1e-3, schedule="plateau",
                            lr_plateau_patience=1, lr_plateau_factor=0.5,
                            lr_plateau_min_delta=10.0)  # never an improvement
    state = _trainer(tmp_path, "p", 2, optim).fit()
    decayed = float(np.float32(5e-4))
    assert state.optimizer.param_groups[0]["lr"] == decayed
    state = _trainer(tmp_path, "p", 3, optim).fit(resume=str(tmp_path / "p"))
    # the controller restarts on resume: epoch 2 sets its best, no decay yet
    assert state.optimizer.param_groups[0]["lr"] == decayed
    lrs = _by_key(_records(tmp_path / "p_logs"), "lr")
    assert lrs[1] == pytest.approx(1e-3) and lrs[5] == lrs[6] == decayed
    assert read_current_lr(optim, state.optimizer, state.step) == decayed
