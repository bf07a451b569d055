"""The port's spatially partitioned inference and training against the JAX package's.

The JAX package shards a volume's or a batch's X axis over a (data,
space) mesh and lets GSPMD insert the halos and the global reductions; the
port runs one gloo rank per slab (``tests/torch_sp_ranks.py``, four CPU
processes started by the port's launcher, killed after ``RANK_TIMEOUT``)
and makes them itself.  The JAX side runs in this process on the first 4
of the 8 virtual CPU devices, as 1 x 4 and 2 x 2 meshes, so both
packages pad and split the same extents (JAX pads X = 50 to 52 over 4).

Tolerances: class maps equal outside the 1e-4 top-2 band of the
unsplit logits (or TTA activations), the serving bound, since the slabs'
convolutions sum in another order; the norm-free contract 1e-5 × max
|ref| against JAX's padded-volume oracle, and JAX's negative control (a
too-small halo differs by more than atol 1e-4); the refusal's words
equal; the 2 x 2 train step with JAX's own mirror draws: losses atol
1e-5, the first step's gradients 1e-4 × max |g|, every parameter after 3
SGD steps atol 2e-5 (``tests/test_sharding.py``'s own bound, which it
holds on one Adam leaf: Adam's first steps move a parameter by ±lr where
its gradient is noise, so SGD here); an uneven plan against
one process of the port and remat 1 / all against remat 0 under a space
axis: losses atol 1e-5, parameters atol 2e-5 and rtol 1e-5, atol 1e-6;
a cbr UNet3D's running statistics rtol 1e-5, atol 1e-6 (the BatchNorm tests' bound).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_parallel import run_ranks
from tpu_mednet.inference.common import tta_split_activations as jax_tta
from tpu_mednet.inference.spatial import predict_volume_spatial as jax_predict_spatial
from tpu_mednet.inference.spatial import receptive_halo as jax_receptive_halo
from tpu_mednet.models import UNet3DBase, UNetConfig
from tpu_mednet.ops.augment import AugmentConfig as JaxAugmentConfig
from tpu_mednet.parallel import replicated
from tpu_mednet.parallel.mesh import make_mesh as jax_make_mesh
from tpu_mednet.parallel.mesh import train_batch_sharding
from tpu_mednet.tasks import SegmentationTask as JaxSegmentationTask
from tpu_mednet.train import OptimizerConfig as JaxOptimizerConfig
from tpu_mednet.train import create_train_state as jax_create_train_state
from tpu_mednet.train import make_train_step as jax_make_train_step
from tpu_mednet_torch.inference import receptive_halo
from tpu_mednet_torch.models import ResidualUNet3D
from tpu_mednet_torch.tasks import SegmentationTask
from tpu_mednet_torch.train import OptimizerConfig, create_train_state, make_train_step
from tpu_mednet_torch.utils.weights import load_jax_params, state_dict_from_jax

WORLD = 4
BAND = 1e-4
SGD = dict(name="sgd", learning_rate=0.05, momentum=0.9)
BATCH = (4, 16, 8, 8, 1)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _cf(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 4, 1, 2, 3)


def _jax_model(**kw):
    cfg = dict(in_channels=1, out_channels=2, f_maps=4, num_levels=2, num_groups=2,
               dtype=jnp.float32)
    return UNet3DBase(config=UNetConfig(**{**cfg, **kw}))


def _mesh(n_data, n_space):
    return jax_make_mesh(n_data=n_data, n_space=n_space, devices=jax.devices()[:WORLD])


def _seg_batch(seed):
    rng = np.random.default_rng(seed)
    return {"data": rng.normal(size=BATCH).astype(np.float32),
            "label": rng.integers(0, 2, size=BATCH).astype(np.uint8)}


def _mirror_draws(rng, steps, n):
    """The mirror flips JAX's train step draws from ``state.rng`` at each
    step, as the port's (axes, N) bool draws."""
    out = []
    for _ in range(steps):
        aug, rng = jax.random.split(rng)
        k_m = jax.random.split(aug, 6)[3]
        keys = jax.random.split(k_m, 3)
        out.append(torch.from_numpy(np.stack([np.asarray(
            jax.random.bernoulli(k, 0.5, (n, 1, 1, 1, 1))).reshape(n) for k in keys])))
    return out


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("spatial")
    model = _jax_model()
    variables = {"params": jax_create_train_state(model, (1, 16, 16, 16, 1), 1e-3,
                                                  seed=0).params}
    norm_free = _jax_model(layer_order="cr")
    nf_vars = {"params": jax_create_train_state(norm_free, (1, 16, 16, 16, 1), 1e-3,
                                                seed=0).params}
    rng = np.random.default_rng(0)
    vols = {"v64": rng.normal(size=(1, 64, 16, 16)).astype(np.float32),
            "v50": np.random.default_rng(1).normal(size=(1, 50, 16, 16)).astype(np.float32),
            "vtta": np.random.default_rng(5).normal(size=(1, 64, 16, 16)).astype(np.float32)}
    contract_x = np.random.default_rng(4).normal(size=(1, 64, 16, 16, 1)).astype(np.float32)

    jtask = JaxSegmentationTask(model=model, loss="DICE")
    jstate = jax_create_train_state(model, BATCH, 1e-2, seed=0,
                                    optimizer=JaxOptimizerConfig(**SGD).build())
    batch = _seg_batch(3)
    deep = ResidualUNet3D(1, 2, f_maps=4, num_levels=5, num_groups=2, dtype=torch.float32,
                          device="cpu", generator=torch.Generator().manual_seed(2))
    drng = np.random.default_rng(6)
    deep_batches = [{"data": torch.from_numpy(drng.normal(size=(2, 1, 96, 16, 16))
                                              .astype(np.float32)),
                     "label": torch.from_numpy(drng.integers(0, 2, size=(2, 1, 96, 16, 16))
                                               .astype(np.uint8))} for _ in range(2)]
    cbr_cfg = UNetConfig(in_channels=1, out_channels=3, f_maps=8, num_levels=3, block="double",
                         layer_order="cbr", dtype=jnp.float32)
    cbr_task = JaxSegmentationTask(model=UNet3DBase(config=cbr_cfg), loss="DICE")
    cbr_shape = (4, 16, 16, 16, 1)
    cbr_state = jax_create_train_state(cbr_task.model, cbr_shape, 1e-3, seed=0,
                                       optimizer=JaxOptimizerConfig(**SGD).build())
    crng = np.random.default_rng(11)
    cbr_batches = []
    for _ in range(3):
        label = crng.integers(0, 3, size=cbr_shape).astype(np.uint8)
        data = (crng.normal(size=cbr_shape) + label).astype(np.float32)
        cbr_batches.append({"data": data, "label": label})

    inputs = {"residual": state_dict_from_jax(_np(variables)),
              "norm_free": state_dict_from_jax(_np(nf_vars)),
              **{k: torch.from_numpy(v) for k, v in vols.items()},
              "contract_x": _cf(contract_x),
              "batch": {k: _cf(v) for k, v in batch.items()},
              "mirror_draws": _mirror_draws(jstate.rng, 3, BATCH[0]),
              "deep": deep.state_dict(), "deep_batches": deep_batches,
              "cbr": state_dict_from_jax(_np({"params": cbr_state.params,
                                              "batch_stats": cbr_state.batch_stats})),
              "cbr_batches": [{k: _cf(v) for k, v in b.items()} for b in cbr_batches]}
    (root / "spec.json").write_text(json.dumps({"jobs": ["predict", "train"]}))
    torch.save(inputs, root / "inputs.pt")
    run_ranks(root, "tests.torch_sp_ranks", [str(root)], nprocs=WORLD)
    outs = [torch.load(root / f"rank{r}.pt") for r in range(WORLD)]
    return dict(outs=outs, inputs=inputs, vols=vols, variables=variables, model=model,
                nf=(norm_free, nf_vars), contract_x=contract_x, jtask=jtask, jstate=jstate,
                batch=batch, cbr=(cbr_task, cbr_state, cbr_batches))


def _top2_gap(act: np.ndarray) -> np.ndarray:
    """(C, X, Y, Z) fp32 activations -> the gap between the two largest."""
    part = np.sort(act, axis=0)
    return part[-1] - part[-2]


def _assert_maps(got: torch.Tensor, want: np.ndarray, act: np.ndarray, what: str):
    """Class maps equal outside the tie band of ``act`` (C, X, Y, Z) probabilities."""
    got = got.numpy()
    assert got.shape == want.shape and got.dtype == np.uint8, what
    off = got != want
    outside = off & (_top2_gap(act)[None] >= BAND)
    assert not outside.any(), (what, int(off.sum()), int(outside.sum()))


def _padded_probs(setup, vol, flips=(), n_space=WORLD):
    """The unsplit softmax (or TTA activations) of the volume padded as the
    split predictor pads it, cut back to the volume."""
    x = np.moveaxis(vol, 0, -1)[None]
    pad = (-x.shape[1]) % int(np.lcm(n_space, 2))
    xp = jnp.asarray(np.pad(x, [(0, 0), (0, pad), (0, 0), (0, 0), (0, 0)]))
    jtask = JaxSegmentationTask(model=setup["model"], loss="DICE")
    act = jax_tta(jtask, setup["variables"], xp, tuple(flips)) if flips else \
        jax.nn.softmax(setup["model"].apply(setup["variables"], xp, train=False), axis=-1)
    return np.moveaxis(np.asarray(act)[0, :vol.shape[1]], -1, 0)


# -- (d) whole-volume inference against JAX's ------------------------------------


@pytest.mark.parametrize("key,vol,flips", [("auto64", "v64", ()), ("auto50", "v50", ()),
                                           ("tta", "vtta", (0, 2)), ("tta50", "v50", (0, 1))])
def test_auto_equals_jax(setup, key, vol, flips):
    jtask = JaxSegmentationTask(model=setup["model"], loss="DICE")
    want = jax_predict_spatial(jtask, setup["variables"], setup["vols"][vol], _mesh(1, WORLD),
                               mode="auto", tta_flips=flips)
    act = _padded_probs(setup, setup["vols"][vol], flips)
    for r, out in enumerate(setup["outs"]):
        _assert_maps(out["predict"][key], want, act, f"{key} rank {r}")
    assert want.shape == setup["vols"][vol].shape


@pytest.mark.parametrize("key,flips", [("explicit", ()), ("explicit_tta", (2,))])
def test_explicit_equals_jax(setup, key, flips):
    vol = setup["vols"]["vtta" if flips else "v64"]
    jtask = JaxSegmentationTask(model=setup["model"], loss="DICE")
    want = jax_predict_spatial(jtask, setup["variables"], vol, _mesh(1, WORLD),
                               mode="explicit", halo=4, tta_flips=flips)
    # the band of each padded shard's own forward, as explicit computes it
    acts = []
    x = np.pad(np.moveaxis(vol, 0, -1)[None], [(0, 0), (4, 4), (0, 0), (0, 0), (0, 0)])
    for s in range(WORLD):
        win = jnp.asarray(x[:, 16 * s:16 * s + 24])
        act = jax_tta(jtask, setup["variables"], win, flips) if flips else jax.nn.softmax(
            setup["model"].apply(setup["variables"], win, train=False), axis=-1)
        acts.append(np.asarray(act)[0, 4:-4])
    act = np.moveaxis(np.concatenate(acts), -1, 0)
    for r, out in enumerate(setup["outs"]):
        _assert_maps(out["predict"][key], want, act, f"{key} rank {r}")


def test_explicit_default_halo_equals_the_slab_oracle(setup):
    """The default halo (``receptive_halo`` rounded to the pool: 18 rows)
    reaches past the next 16-row slab; each slab equals one process's
    forward of its window of the zero-padded volume, cropped."""
    assert receptive_halo(2) == jax_receptive_halo(2) == 18
    assert [receptive_halo(n) for n in (3, 5)] == [jax_receptive_halo(n) for n in (3, 5)]
    vol = setup["vols"]["v64"]
    x = jnp.asarray(np.pad(np.moveaxis(vol, 0, -1)[None],
                           [(0, 0), (18, 18), (0, 0), (0, 0), (0, 0)]))
    maps, acts = [], []
    for s in range(WORLD):
        logits = setup["model"].apply(setup["variables"], x[:, 16 * s:16 * s + 52], train=False)
        maps.append(np.asarray(jnp.argmax(jax.nn.softmax(logits, -1), -1))[0, 18:-18])
        acts.append(np.asarray(jax.nn.softmax(logits, -1))[0, 18:-18])
    want = np.concatenate(maps)[None].astype(np.uint8)
    act = np.moveaxis(np.concatenate(acts), -1, 0)
    for out in setup["outs"]:
        _assert_maps(out["predict"]["explicit_default"], want, act, "explicit default")


def test_explicit_refuses_the_split_axis_with_jax_words(setup):
    jtask = JaxSegmentationTask(model=setup["model"], loss="DICE")
    with pytest.raises(ValueError) as want:
        jax_predict_spatial(jtask, setup["variables"], setup["vols"]["v64"], _mesh(1, WORLD),
                            mode="explicit", halo=4, tta_flips=(0,))
    for out in setup["outs"]:
        assert out["predict"]["refusal"] == str(want.value)


def test_norm_free_contract_equals_jax_oracle(setup):
    """``tests/test_spatial_inference.py:152-200``: with a halo covering the
    reach (18, two slabs away here), the slabs equal crop(fn(zero_pad(x,
    halo)), halo) of the whole volume; a halo of 2 does not."""
    model, variables = setup["nf"]
    x = setup["contract_x"]

    def oracle(halo):
        out = model.apply(variables, jnp.pad(jnp.asarray(x),
                                             [(0, 0), (halo, halo), (0, 0), (0, 0), (0, 0)]),
                          train=False)
        return np.asarray(out[:, halo:out.shape[1] - halo])

    for halo in (18, 2):
        got = torch.cat([o["predict"][f"contract{halo}"] for o in setup["outs"]], dim=2)
        got = got.permute(0, 2, 3, 4, 1).numpy()
        want = oracle(halo)
        if halo == 18:
            assert float(np.abs(got - want).max()) <= 1e-5 * float(np.abs(want).max())
        else:
            assert not np.allclose(got, oracle(halo), atol=1e-4)


# -- (e, f) training against JAX's and against one process ------------------------


def test_dp_sp_step_with_jax_mirror_draws_equals_jax(setup):
    """2 x 2 (data, space) SGD steps with JAX's own mirror flips of the
    three axes, the split X axis among them, against JAX's make_train_step
    over a 2 x 2 mesh: the losses, the first step's gradients and the
    parameters after 3 steps; the four ranks bit-equal."""
    jtask, jstate, batch = setup["jtask"], setup["jstate"], setup["batch"]
    mesh = _mesh(2, 2)
    augment = JaxAugmentConfig(brightness_sigma=0.0, gamma_range=None, contrast_range=None,
                               mirror_axes=(1, 2, 3))
    jstate = jax.device_put(jstate, replicated(mesh))
    sharding = train_batch_sharding(mesh)
    jbatch = jax.tree.map(lambda a: jax.device_put(a, sharding), batch)
    # the first step's gradient, on the batch flipped as the step flips it
    flips = setup["inputs"]["mirror_draws"][0].numpy()
    data, label = batch["data"].copy(), batch["label"].copy()
    for axis, flip in zip((1, 2, 3), flips):
        for i in np.nonzero(flip)[0]:
            data[i], label[i] = np.flip(data[i], axis - 1), np.flip(label[i], axis - 1)

    def loss_of(params):
        out = jtask.model.apply({"params": params}, jnp.asarray(data), train=True)
        return jtask.loss_fn(out, {"data": jnp.asarray(data), "label": jnp.asarray(label)})[0]

    grads = state_dict_from_jax({"params": _np(jax.grad(loss_of)(jstate.params))})
    step = jax_make_train_step(jtask, augment=augment, donate=False)
    losses = []
    for _ in range(3):
        jstate, m = step(jstate, jbatch)
        losses.append(float(m["train_loss"]))
    want = state_dict_from_jax({"params": _np(jstate.params)})
    outs = [o["train"]["jax_mirror"] for o in setup["outs"]]
    for r, out in enumerate(outs):
        np.testing.assert_allclose(out["losses"].numpy(), losses, rtol=0, atol=1e-5)
        for k, g in grads.items():
            assert float((out["grads"][k] - g).abs().max()) <= 1e-4 * float(g.abs().max()), \
                (r, k)
        for k, p in want.items():
            np.testing.assert_allclose(out["state"][k].numpy(), p.numpy(), rtol=0, atol=2e-5,
                                       err_msg=f"rank {r} {k}")
    for k in outs[0]["state"]:
        assert all(torch.equal(outs[0]["state"][k], o["state"][k]) for o in outs[1:]), k


def test_uneven_plan_equals_one_process(setup):
    """X = 96 over 4 ranks at 5 levels: slabs of (32, 32, 16, 16) rows,
    every level's pooling whole on its rank, against one process."""
    deep = ResidualUNet3D(1, 2, f_maps=4, num_levels=5, num_groups=2, dtype=torch.float32,
                          device="cpu")
    deep.load_state_dict(setup["inputs"]["deep"])
    state = create_train_state(deep, optimizer=OptimizerConfig(**SGD), seed=0)
    step = make_train_step(SegmentationTask(model=deep, loss="DICE"))
    losses = []
    for batch in setup["inputs"]["deep_batches"]:
        state, m = step(state, batch)
        losses.append(float(m["train_loss"]))
    for out in setup["outs"]:
        got = out["train"]["uneven"]
        np.testing.assert_allclose(got["losses"].numpy(), losses, rtol=0, atol=1e-5)
        for k, v in deep.state_dict().items():
            np.testing.assert_allclose(got["state"][k].numpy(), v.numpy(), rtol=0, atol=2e-5,
                                       err_msg=k)


@pytest.mark.parametrize("remat", ["1", "True"])
def test_remat_under_a_space_axis_equals_remat_0(setup, remat):
    """The backward recomputes a stage's halo exchanges and GroupNorm sums
    on every rank in the same order; the result is remat 0's."""
    for out in setup["outs"]:
        got, want = out["train"][f"remat{remat}"], out["train"]["remat0"]
        np.testing.assert_allclose(got["losses"].numpy(), want["losses"].numpy(), rtol=1e-5,
                                   atol=1e-6)
        for k, v in want["state"].items():
            np.testing.assert_allclose(got["state"][k].numpy(), v.numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=k)


def test_cbr_running_statistics_equal_jax_dp_sp_step(setup):
    task, state, batches = setup["cbr"]
    mesh = _mesh(2, 2)
    state = jax.device_put(state, replicated(mesh))
    sharding = train_batch_sharding(mesh)
    step = jax_make_train_step(task, augment=None, donate=False)
    losses = []
    for b in batches:
        state, m = step(state, jax.tree.map(lambda a: jax.device_put(a, sharding), b))
        losses.append(float(m["train_loss"]))
    want = state_dict_from_jax({"params": _np(state.params),
                                "batch_stats": _np(state.batch_stats)})
    keys = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert len(keys) == 20
    for out in setup["outs"]:
        got = out["train"]["cbr"]
        np.testing.assert_allclose(got["losses"].numpy(), losses, rtol=0, atol=1e-5)
        for k in keys:
            np.testing.assert_allclose(got["state"][k].numpy(), want[k].numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=k)


def test_load_jax_params_round_trip(setup):
    """The ranks started from the JAX package's weights, carried bit for bit."""
    model = ResidualUNet3D(1, 2, f_maps=4, num_levels=2, num_groups=2, dtype=torch.float32,
                           device="cpu")
    load_jax_params(model, _np(setup["variables"]))
    for k, v in model.state_dict().items():
        assert torch.equal(v, setup["inputs"]["residual"][k]), k
