"""The port's data parallelism against the JAX package's, on the CPU.

The JAX package shards one global batch over a mesh and lets GSPMD make
every batch reduction global; the port runs one rank per device, each on
its rows, and all-reduces the reductions itself.  Here the ranks are two
gloo processes on the CPU, started by the port's own launcher
(``parallel/multihost.launch_local``, running ``tests/torch_dp_ranks.py``)
with a hard timeout of their own (``RANK_TIMEOUT``: killed, and the test
failed, so that a hung collective cannot hold up the suite); the JAX side
runs on a 2-device mesh of the 8 virtual CPU devices.

Tolerances: the losses and their gradients rtol 1e-6 and atol 1e-6 (the
loss tests' own), each rank's logits gradient being ``world_size`` times
JAX's rows (the backward of the autograd all-reduce sums; the averaged
parameter gradients take the factor back); one dp train step's loss atol
1e-5 and gradients 1e-4 × max |g| and eval metrics atol 1e-5 (the train
step's bounds); a cbr UNet3D's running statistics after 3 SGD steps rtol
1e-5, atol 1e-6 (the single-process BatchNorm tests' bound; the port's
global statistics are flax's E[x²] − E[x]², all-reduced); ``train_seg
--gpus 2`` per-logged-step losses
and validation means atol 1e-5 against the JAX CLI's (the Trainer's
bound); the ranks' parameters after each step bit-equal to each other;
round-robin prediction over two devices equal to one device (exact: each
volume runs whole on one device, on the same weights).
"""

import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_mednet.models import UNet3DBase, UNetConfig
from tpu_mednet.ops import losses as JL
from tpu_mednet.parallel import make_mesh as jax_make_mesh
from tpu_mednet.parallel import replicated, shard_batch
from tpu_mednet.parallel import mesh as jax_mesh
from tpu_mednet.parallel import multihost as jax_multihost
from tpu_mednet.tasks import SegmentationTask as JaxSegmentationTask
from tpu_mednet.train import OptimizerConfig as JaxOptimizerConfig
from tpu_mednet.train import create_train_state as jax_create_train_state
from tpu_mednet.train import make_eval_step as jax_make_eval_step
from tpu_mednet.train import make_train_step as jax_make_train_step
from tpu_mednet_torch.models import ResidualUNet3D, UNet3D
from tpu_mednet_torch.ops.augment import AugmentConfig
from tpu_mednet_torch.parallel import mesh, multihost
from tpu_mednet_torch.tasks import SegmentationTask
from tpu_mednet_torch.train import create_train_state, make_train_step
from tpu_mednet_torch.utils.weights import load_jax_params, state_dict_from_jax

REPO = Path(__file__).resolve().parent.parent
RANK_TIMEOUT = 120       # seconds for one launch of the ranks, start to exit
WORLD = 2
LAUNCH = ("import sys; from tpu_mednet_torch.parallel.multihost import launch_local; "
          "sys.exit(launch_local(sys.argv[1], sys.argv[2:-1], int(sys.argv[-1])))")
LOSS_TOL = dict(rtol=1e-6, atol=1e-6)
STATS_TOL = dict(rtol=1e-5, atol=1e-6)
GLOBAL_BATCH = (4, 16, 16, 16, 1)


def run_launch(argv, timeout=RANK_TIMEOUT, env=None):
    """Run ``argv`` in a session of its own; on timeout kill the whole
    session (the ranks with it) and fail."""
    proc = subprocess.Popen(argv, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, start_new_session=True, env=env)
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        pytest.fail(f"{argv[:4]} did not end within {timeout} s: killed")
    return proc.returncode, out


def run_ranks(root: Path, module: str, args, nprocs: int = WORLD):
    rc, out = run_launch([sys.executable, "-c", LAUNCH, module, *args, str(nprocs)],
                         env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert rc == 0, out[-4000:]
    return out


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _cf(a: np.ndarray) -> torch.Tensor:
    """(N, X, Y, Z, C) numpy -> the port's (N, C, X, Y, Z) channels-last view."""
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 4, 1, 2, 3)


def _seg_batch(seed, classes=2):
    rng = np.random.default_rng(seed)
    label = np.zeros(GLOBAL_BATCH, np.uint8)
    label[:, 4:12, 3:11, 5:13] = 1
    if classes > 2:
        label[1::2, 9:14, 2:6, 8:14] = 2
    data = (rng.normal(size=GLOBAL_BATCH) + 1.5 * (label > 0)).astype(np.float32)
    return data, label


# -- the helpers against JAX's, single process ---------------------------------


@pytest.mark.parametrize("n,pi,pc", [(7, 0, 1), (7, 0, 2), (7, 1, 2), (9, 2, 3), (2, 1, 2)])
def test_shard_subject_keys_equals_jax(n, pi, pc, caplog):
    keys = [f"k{i}" for i in range(n)]
    with caplog.at_level("WARNING"):
        want = jax_mesh.shard_subject_keys(keys, pi, pc)
    jax_warnings = [r.getMessage() for r in caplog.records]
    caplog.clear()
    with caplog.at_level("WARNING"):
        got = mesh.shard_subject_keys(keys, pi, pc)
    assert got == want
    assert [r.getMessage() for r in caplog.records] == jax_warnings


def test_shard_subject_keys_zero_share_refused_as_jax():
    with pytest.raises(ValueError) as want:
        jax_mesh.shard_subject_keys(["a", "b"], 0, 3)
    with pytest.raises(ValueError) as got:
        mesh.shard_subject_keys(["a", "b"], 0, 3)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("batch,pc", [(8, 1), (8, 2), (12, 4), (6, 4)])
def test_local_batch_size_and_pad_equal_jax(batch, pc, monkeypatch):
    monkeypatch.setattr(jax, "process_count", lambda: pc)
    try:
        want = jax_multihost.local_batch_size(batch)
    except ValueError as exc:
        with pytest.raises(ValueError) as got:
            multihost.local_batch_size(batch, pc)
        assert str(got.value) == str(exc)
    else:
        assert multihost.local_batch_size(batch, pc) == want
    for m in (1, 3, 4):
        assert mesh.pad_to_multiple(batch, m) == jax_mesh.pad_to_multiple(batch, m)


JAX_ENV = ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID")
PORT_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")
JAX_VALUES = {"JAX_COORDINATOR_ADDRESS": "localhost:1234", "JAX_NUM_PROCESSES": "2",
              "JAX_PROCESS_ID": "0"}
PORT_VALUES = {"MASTER_ADDR": "localhost", "MASTER_PORT": "1234", "WORLD_SIZE": "2",
               "RANK": "0", "LOCAL_RANK": "0"}


@pytest.mark.parametrize("which", ["none", "first", "all_but_last", "one_world"])
def test_environment_checks_as_jax(which, monkeypatch):
    """No variables: neither package starts anything.  A partial set: both
    refuse with the same message shape, naming every variable they need.
    A complete one-process world: nothing to join."""
    for k in (*JAX_ENV, *PORT_ENV, "TPU_MEDNET_DISTRIBUTED"):
        monkeypatch.delenv(k, raising=False)
    if which == "none":
        assert jax_multihost.maybe_initialize_distributed() is False
        assert multihost.maybe_initialize_distributed("gloo") is False
        assert multihost.distributed_env() is None
        return
    if which == "one_world":
        env = {**PORT_VALUES, "WORLD_SIZE": "1"}
        assert multihost.maybe_initialize_distributed("gloo", env=env) is False
        return
    take = slice(0, 1) if which == "first" else slice(0, -1)
    for k in JAX_ENV[take]:
        monkeypatch.setenv(k, JAX_VALUES[k])
    env = {k: PORT_VALUES[k] for k in PORT_ENV[take]}
    with pytest.raises(ValueError) as want:
        jax_multihost.maybe_initialize_distributed()
    with pytest.raises(ValueError) as got:
        multihost.maybe_initialize_distributed("gloo", env=env)
    prefix = "incomplete multi-process environment: need ALL of "
    assert str(want.value).startswith(prefix) and str(got.value).startswith(prefix)
    assert all(k in str(got.value) for k in PORT_ENV)
    assert all(k in str(want.value) for k in JAX_ENV)


def test_rows_and_node_shares():
    m = mesh.DataMesh(rank=3, world_size=4, devices=(torch.device("cpu"),) * 2,
                      node_index=1, node_count=2)
    assert (m.local_rank, m.ranks_per_node, m.parallel) == (1, 2, True)
    assert m.rows(8) == slice(6, 8) and m.rows(4, within_node=True) == slice(2, 4)
    with pytest.raises(ValueError, match="does not split evenly"):
        m.rows(6)
    with pytest.raises(ValueError, match="devices"):
        mesh.DataMesh(rank=0, world_size=2, devices=(torch.device("cpu"),))
    one = mesh.make_mesh("cpu")
    assert not one.parallel and one.rows(5) == slice(0, 5)
    t = torch.ones(3, requires_grad=True)
    assert one.all_sum(t) is t
    batch = {"data": torch.arange(8).view(4, 2), "subject_key": list("abcd"),
             "selected_class": np.arange(4), "n": 7}
    cut = multihost.take_rows(batch, slice(1, 3))
    assert cut["subject_key"] == ["b", "c"] and cut["n"] == 7
    assert cut["data"].tolist() == [[2, 3], [4, 5]] and cut["selected_class"].tolist() == [1, 2]


# -- two gloo ranks against JAX ------------------------------------------------


def _residual_setup():
    cfg = UNetConfig(in_channels=1, out_channels=2, f_maps=8, num_levels=3,
                     dtype=jnp.float32)
    jtask = JaxSegmentationTask(model=UNet3DBase(config=cfg), loss="DICE")
    jstate = jax_create_train_state(jtask.model, GLOBAL_BATCH, learning_rate=1e-3, seed=0)
    model = ResidualUNet3D(1, 2, f_maps=8, num_levels=3, dtype=torch.float32, device="cpu")
    load_jax_params(model, {"params": _np(jstate.params)})
    return jtask, jstate, model


SGD = dict(name="sgd", learning_rate=0.05, momentum=0.9)


def _cbr_setup():
    cfg = UNetConfig(in_channels=1, out_channels=3, f_maps=8, num_levels=3, block="double",
                     layer_order="cbr", dtype=jnp.float32)
    jtask = JaxSegmentationTask(model=UNet3DBase(config=cfg), loss="DICE")
    jstate = jax_create_train_state(jtask.model, GLOBAL_BATCH, learning_rate=1e-3, seed=0,
                                    optimizer=JaxOptimizerConfig(**SGD).build())
    model = UNet3D(1, 3, f_maps=8, num_levels=3, layer_order="cbr", dtype=torch.float32,
                   device="cpu")
    load_jax_params(model, {"params": _np(jstate.params),
                            "batch_stats": _np(jstate.batch_stats)})
    return jtask, jstate, model


def _loss_inputs():
    rng = np.random.default_rng(7)
    shape = (4, 8, 8, 8)
    return dict(logits=rng.normal(size=(4, 3, *shape[1:])).astype(np.float32),
                logits_ldmk=rng.normal(scale=3.0, size=(4, 6, *shape[1:])).astype(np.float32),
                labels=rng.integers(0, 3, size=shape).astype(np.int64),
                heatmaps=rng.uniform(0, 255, size=(4, 3, *shape[1:])).astype(np.float32))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """One launch of two ranks running every job; their outputs, and the
    models and batches they started from."""
    root = tmp_path_factory.mktemp("dp")
    li = _loss_inputs()
    jtask, jstate, model = _residual_setup()
    cjtask, cjstate, cbr = _cbr_setup()
    batch = _seg_batch(0)
    cbr_batches = [_seg_batch(10 + i, classes=3) for i in range(3)]
    inputs = {**{k: torch.from_numpy(v) for k, v in li.items()},
              "residual": model.state_dict(), "cbr": cbr.state_dict(),
              "batch": {"data": _cf(batch[0]), "label": _cf(batch[1])},
              "cbr_batches": [{"data": _cf(d), "label": _cf(lb)} for d, lb in cbr_batches]}
    (root / "spec.json").write_text(json.dumps(
        {"jobs": ["losses", "step", "step_augment", "cbr"]}))
    torch.save(inputs, root / "inputs.pt")
    run_ranks(root, "tests.torch_dp_ranks", [str(root)])
    outs = [torch.load(root / f"rank{r}.pt") for r in range(WORLD)]
    return dict(outs=outs, losses=li, residual=(jtask, jstate), cbr=(cjtask, cjstate),
                batch=batch, cbr_batches=cbr_batches, model_state=model.state_dict())


def _jax_loss_cases():
    onehot = lambda y: JL.expand_as_one_hot(y, 3)
    reg_w = [0.015, 0.001, 0.02]
    return {
        "dice": lambda z, y, hm: JL.dice_loss(z, y),
        "ce": lambda z, y, hm: JL.ce_loss(z, y),
        "ce_weighted": lambda z, y, hm: JL.ce_loss(z, y, weight=jnp.asarray([0.3, 1.0, 2.0])),
        "wce": lambda z, y, hm: JL.weighted_ce_loss(z, onehot(y)),
        "landmark": lambda z, y, hm: JL.multitask_landmark_loss(
            z[..., 3:], z[..., :3], y, hm, reg_w)[0],
        "landmark_ce_l1": lambda z, y, hm: JL.multitask_landmark_loss(
            z[..., 3:], z[..., :3], y, hm, reg_w, class_loss="CE", regression_loss="L1")[0],
    }


@pytest.mark.parametrize("name", list(_jax_loss_cases()))
def test_losses_and_gradients_over_ranks_equal_jax_on_the_global_batch(ranks, name):
    li = ranks["losses"]
    z = li["logits_ldmk" if name.startswith("landmark") else "logits"]
    hm = np.moveaxis(li["heatmaps"], 1, -1)
    fn = _jax_loss_cases()[name]
    loss, grad = jax.value_and_grad(lambda zz: fn(zz, jnp.asarray(li["labels"]),
                                                  jnp.asarray(hm)))(
        jnp.asarray(np.moveaxis(z, 1, -1)))
    grad = np.moveaxis(np.asarray(grad), -1, 1)
    for r, out in enumerate(ranks["outs"]):
        got_loss, got_grad = out["losses"][name]
        np.testing.assert_allclose(float(got_loss), float(loss), **LOSS_TOL)
        rows = slice(2 * r, 2 * r + 2)
        np.testing.assert_allclose(got_grad.numpy() / WORLD, grad[rows], **LOSS_TOL,
                                   err_msg=f"{name} rank {r}")


def test_dp_step_equals_jax_step_on_a_two_device_mesh(ranks):
    jtask, jstate = ranks["residual"]
    data, label = ranks["batch"]
    jmesh = jax_make_mesh(n_data=WORLD)
    jstate = jax.device_put(jstate, replicated(jmesh))
    jbatch = shard_batch({"data": data, "label": label}, jmesh)

    def loss_of(params):
        out = jtask.model.apply({"params": params}, jbatch["data"], train=True)
        return jtask.loss_fn(out, jbatch)[0]

    grads = state_dict_from_jax({"params": _np(jax.jit(jax.grad(loss_of))(jstate.params))})
    evals = jax_make_eval_step(jtask)(jstate, jbatch)
    _, metrics = jax_make_train_step(jtask, augment=None, donate=False)(jstate, jbatch)
    outs = [o["step"] for o in ranks["outs"]]
    for r, out in enumerate(outs):
        # every rank's rows gathered back, in rank order, into the global batch
        assert np.array_equal(out["assembled"]["data"].permute(0, 2, 3, 4, 1).numpy(), data)
        assert np.array_equal(out["assembled"]["label"].permute(0, 2, 3, 4, 1).numpy(), label)
        assert abs(float(out["loss"]) - float(metrics["train_loss"])) <= 1e-5, r
        assert sorted(out["eval"]) == sorted(evals)
        for k in evals:
            assert abs(float(out["eval"][k]) - float(evals[k])) <= 1e-5, (r, k)
        assert sorted(out["grads"]) == sorted(grads)
        for k, g in grads.items():
            scale = float(g.abs().max())
            assert float((out["grads"][k] - g).abs().max()) <= 1e-4 * scale, (r, k)
    for k in outs[0]["params"]:
        assert torch.equal(outs[0]["params"][k], outs[1]["params"][k]), k
        assert torch.equal(outs[0]["grads"].get(k, torch.zeros(())),
                           outs[1]["grads"].get(k, torch.zeros(()))), k


def test_dp_augmented_steps_equal_one_process_on_the_global_batch(ranks):
    """The augmentation is drawn for the global batch and each rank takes
    its rows' draws: two ranks give one process's two steps."""
    model = ResidualUNet3D(1, 2, f_maps=8, num_levels=3, dtype=torch.float32, device="cpu")
    model.load_state_dict(ranks["model_state"])
    task = SegmentationTask(model=model, loss="DICE")
    state = create_train_state(model, learning_rate=1e-3, seed=3)
    step = make_train_step(task, augment=AugmentConfig(mirror_axes=(1, 2, 3)))
    data, label = ranks["batch"]
    losses = []
    for _ in range(2):
        state, m = step(state, {"data": _cf(data), "label": _cf(label)})
        losses.append(float(m["train_loss"]))
    outs = [o["step_augment"] for o in ranks["outs"]]
    for out in outs:
        np.testing.assert_allclose(out["losses"].numpy(), losses, rtol=0, atol=1e-5)
    assert all(torch.equal(outs[0]["params"][k], outs[1]["params"][k]) for k in outs[0]["params"])


def test_cbr_running_statistics_equal_jax_dp_step(ranks):
    jtask, jstate = ranks["cbr"]
    jmesh = jax_make_mesh(n_data=WORLD)
    jstate = jax.device_put(jstate, replicated(jmesh))
    step = jax_make_train_step(jtask, augment=None, donate=False)
    losses = []
    for data, label in ranks["cbr_batches"]:
        jstate, m = step(jstate, shard_batch({"data": data, "label": label}, jmesh))
        losses.append(float(m["train_loss"]))
    want = state_dict_from_jax({"params": _np(jstate.params),
                                "batch_stats": _np(jstate.batch_stats)})
    keys = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert len(keys) == 20
    outs = [o["cbr"] for o in ranks["outs"]]
    for out in outs:
        np.testing.assert_allclose(out["losses"].numpy(), losses, rtol=0, atol=1e-5)
        for k in keys:
            np.testing.assert_allclose(out["state"][k].numpy(), want[k].numpy(), err_msg=k,
                                       **STATS_TOL)
    assert all(torch.equal(outs[0]["state"][k], outs[1]["state"][k]) for k in outs[0]["state"])


# -- round-robin inference -----------------------------------------------------


def test_round_robin_over_two_devices_equals_one(tmp_path):
    from tpu_mednet_torch.data import MemoryReader
    from tpu_mednet_torch.inference import (predict_volumes, predict_volumes_on_device,
                                            predict_volumes_weighted_on_device)
    from tpu_mednet_torch.inference.common import round_robin_placement

    rng = np.random.default_rng(5)
    shapes = {"a": (20, 18, 22), "b": (18, 20, 16), "c": (22, 16, 18)}
    reader = MemoryReader({"images": {k: rng.normal(size=(1, *s)).astype(np.float32)
                                      for k, s in shapes.items()}})
    model = ResidualUNet3D(1, 3, f_maps=4, num_levels=3, dtype=torch.float32, device="cpu",
                           generator=torch.Generator().manual_seed(0))
    task = SegmentationTask(model=model, loss="DICE")
    placement = round_robin_placement(task, ["cpu", "cpu"])
    assert placement.tasks[0] is task and placement.tasks[1].model is not model
    assert round_robin_placement(task, placement) is placement
    assert round_robin_placement(task, None) is None
    for a, b in zip(model.parameters(), placement.tasks[1].model.parameters()):
        assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()
    kw = dict(patch_size=(16, 16, 16), patch_overlap=(4, 4, 4), batch_size=2,
              reader=reader, device="cpu")
    for fn in (predict_volumes, predict_volumes_on_device, predict_volumes_weighted_on_device):
        one = fn(task, None, list(shapes), **kw)
        two = fn(task, None, list(shapes), devices=placement, **kw)
        for k in shapes:
            assert np.array_equal(two[k].array, one[k].array), (fn.__name__, k)


# -- train_seg --gpus 2 against the JAX CLI's ------------------------------------


def test_train_seg_gpus_2_equals_jax_cli(tmp_path):
    """``train_seg --device cpu --gpus 2`` (two gloo ranks the CLI starts
    itself) against the JAX CLI's ``--gpus 2`` (a 2-device mesh), from the
    same initial weights: the JAX Trainer draws them from the seed, the
    port resumes from a step-0 checkpoint that holds them.  The logged
    losses and validation means agree, and rank 0 alone wrote the logs
    and checkpoints."""
    from tests.test_torch_cli import _train_argv, _write_store
    from tpu_mednet.cli import train_seg as jax_train_seg
    from tpu_mednet.config import parse_with_config as jax_parse
    from tpu_mednet_torch.cli import train_seg
    from tpu_mednet_torch.config import parse_with_config
    from tpu_mednet_torch.tasks import SegmentationTask as PortTask
    from tpu_mednet_torch.train import CheckpointManager, OptimizerConfig

    _write_store(tmp_path)
    # seg_organ.yaml without its augmentation: the packages draw it from
    # other generators (the dp augmented step is held against one process
    # of the port above)
    config = tmp_path / "seg_organ.yaml"
    config.write_text("".join(line for line in (REPO / "configs" / "seg_organ.yaml")
                              .read_text().splitlines(keepends=True)
                              if not line.startswith("data_augmentation")))

    def own_config(argv):
        return [str(config) if a.endswith("seg_organ.yaml") else a for a in argv]

    common = ["--max_epochs", "2", "--gpus", "2"]
    jax_argv = [a for a in own_config(_train_argv(tmp_path, *common))
                if a != "--device" and a != "cpu"]
    jax_argv = [a.replace(str(tmp_path / "model"), str(tmp_path / "jax_model"))
                .replace(str(tmp_path / "logs"), str(tmp_path / "jax_logs")) for a in jax_argv]
    assert jax_train_seg.main(jax_argv) == 0

    jhp = jax_parse(jax_train_seg.build_parser(), jax_argv)
    jtask = JaxSegmentationTask.from_hparams(jhp)
    init = jax_create_train_state(jtask.model, (jhp.batch_size, *jhp.patch_size, 1),
                                  jhp.learning_rate, seed=jhp.seed).params
    argv = own_config(_train_argv(tmp_path, *common, "--resume", str(tmp_path / "init")))
    hp = parse_with_config(train_seg.build_parser(), argv)
    task = PortTask.from_hparams(hp, device="cpu")
    load_jax_params(task.model, {"params": _np(init)})
    state = create_train_state(task.model, hp.learning_rate, seed=hp.seed,
                               optimizer=OptimizerConfig.from_hparams(hp))
    CheckpointManager(tmp_path / "init").save(0, state, vars(hp))

    rc, out = run_launch([sys.executable, "-m", "tpu_mednet_torch.cli.train_seg", *argv],
                         env={**os.environ, "TPU_MEDNET_NO_NATIVE": "1", "OMP_NUM_THREADS": "1"})
    assert rc == 0, out[-4000:]

    def records(log_dir):
        return [json.loads(line) for line in (log_dir / "metrics.jsonl").read_text()
                .splitlines()]

    got, want = records(tmp_path / "logs"), records(tmp_path / "jax_logs")
    for name in ("train_loss", "val_loss", "val_dice0", "val_dice1", "val_dice2"):
        g = {r["step"]: r[name] for r in got if name in r}
        w = {r["step"]: r[name] for r in want if name in r}
        assert sorted(g) == sorted(w) and g, name
        for s in w:
            assert abs(g[s] - w[s]) <= 1e-5, (name, s, g[s], w[s])
    # one writer: each record once, one TensorBoard file, the checkpoints of
    # both epochs
    assert len(got) == len(want)
    assert len(list((tmp_path / "logs").glob("events.out.tfevents*"))) == 1
    assert CheckpointManager(tmp_path / "model").available_steps == [3, 6]
