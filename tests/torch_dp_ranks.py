"""The ranks of ``tests/test_torch_parallel.py``: data-parallel jobs on the CPU.

Started by the port's own launcher, one process a rank::

    python -c "from tpu_mednet_torch.parallel.multihost import launch_local; \
        launch_local('tests.torch_dp_ranks', ['<dir>'], 2)"

``<dir>/spec.json`` names the jobs; ``<dir>/inputs.pt`` holds their global
inputs (the JAX package's weights carried into the port, global batches).
Each rank joins a gloo group from the launcher's variables, runs every
job on its rows of the global batches and saves what it got to
``<dir>/rank<r>.pt``.  Imports torch and the port only.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

from tpu_mednet_torch.models import ResidualUNet3D, UNet3D
from tpu_mednet_torch.ops import losses as L
from tpu_mednet_torch.ops.augment import AugmentConfig
from tpu_mednet_torch.parallel import (assemble_global_batch, make_mesh,
                                       maybe_initialize_distributed)
from tpu_mednet_torch.tasks import SegmentationTask
from tpu_mednet_torch.train import (OptimizerConfig, create_train_state, make_eval_step,
                                    make_train_step)

SGD = dict(name="sgd", learning_rate=0.05, momentum=0.9)


def _losses(mesh, inp):
    """Each loss on this rank's rows with ``dp``: its value and the
    gradient of the rows' logits."""
    rows = mesh.rows(inp["logits"].shape[0])
    labels, hm = inp["labels"][rows], inp["heatmaps"][rows]
    onehot = L.expand_as_one_hot(labels, inp["logits"].shape[1])
    cases = {
        "dice": lambda z: L.dice_loss(z, labels, dp=mesh),
        "ce": lambda z: L.ce_loss(z, labels, dp=mesh),
        "ce_weighted": lambda z: L.ce_loss(z, labels, weight=[0.3, 1.0, 2.0], dp=mesh),
        "wce": lambda z: L.weighted_ce_loss(z, onehot, dp=mesh),
        "landmark": lambda z: L.multitask_landmark_loss(
            z[:, 3:], z[:, :3], labels, hm, [0.015, 0.001, 0.02], dp=mesh)[0],
        "landmark_ce_l1": lambda z: L.multitask_landmark_loss(
            z[:, 3:], z[:, :3], labels, hm, [0.015, 0.001, 0.02], class_loss="CE",
            regression_loss="L1", dp=mesh)[0],
    }
    out = {}
    for name, fn in cases.items():
        z = (inp["logits_ldmk"] if name.startswith("landmark") else inp["logits"])[rows]
        z = z.clone().requires_grad_(True)
        loss = fn(z)
        loss.backward()
        out[name] = (loss.detach(), z.grad)
    return out


def _rows(mesh, batch):
    rows = mesh.rows(batch["data"].shape[0])
    return {k: v[rows] for k, v in batch.items()}


def _residual(inp):
    model = ResidualUNet3D(1, 2, f_maps=8, num_levels=3, dtype=torch.float32, device="cpu")
    model.load_state_dict(inp["residual"])
    return SegmentationTask(model=model, loss="DICE")


def _step(mesh, inp):
    """Eval metrics of the initial weights, then one train step (Adam 1e-3)."""
    task = _residual(inp)
    state = create_train_state(task.model, learning_rate=1e-3, seed=0)
    batch = _rows(mesh, inp["batch"])
    metrics = make_eval_step(task, mesh=mesh)(state, batch)
    state, m = make_train_step(task, mesh=mesh)(state, batch)
    return dict(eval={k: v.clone() for k, v in metrics.items()}, loss=m["train_loss"],
                assembled=assemble_global_batch(batch, mesh),
                grads={k: p.grad.clone() for k, p in task.model.named_parameters()},
                params={k: v.clone() for k, v in task.model.state_dict().items()})


def _step_augment(mesh, inp):
    """Two steps with mirror flips and the intensity chain, drawn for the
    global batch."""
    task = _residual(inp)
    state = create_train_state(task.model, learning_rate=1e-3, seed=3)
    step = make_train_step(task, augment=AugmentConfig(mirror_axes=(1, 2, 3)), mesh=mesh)
    losses = []
    for _ in range(2):
        state, m = step(state, _rows(mesh, inp["batch"]))
        losses.append(m["train_loss"])
    return dict(losses=torch.stack(losses),
                params={k: v.clone() for k, v in task.model.state_dict().items()})


def _cbr(mesh, inp):
    """Three SGD steps of a cbr UNet3D: losses and running statistics."""
    model = UNet3D(1, 3, f_maps=8, num_levels=3, layer_order="cbr", dtype=torch.float32,
                   device="cpu")
    model.load_state_dict(inp["cbr"])
    task = SegmentationTask(model=model, loss="DICE")
    state = create_train_state(model, optimizer=OptimizerConfig(**SGD), seed=0)
    step = make_train_step(task, mesh=mesh)
    losses = []
    for batch in inp["cbr_batches"]:
        state, m = step(state, _rows(mesh, batch))
        losses.append(m["train_loss"])
    return dict(losses=torch.stack(losses),
                state={k: v.clone() for k, v in model.state_dict().items()})


JOBS = {"losses": _losses, "step": _step, "step_augment": _step_augment, "cbr": _cbr}


def main(argv) -> int:
    root = Path(argv[0])
    spec = json.loads((root / "spec.json").read_text())
    torch.set_num_threads(1)
    assert maybe_initialize_distributed("gloo")
    mesh = make_mesh("cpu")
    inp = torch.load(root / "inputs.pt")
    out = {name: JOBS[name](mesh, inp) for name in spec["jobs"]}
    torch.save(out, root / f"rank{mesh.rank}.pt")
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
