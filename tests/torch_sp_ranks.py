"""The ranks of ``tests/test_torch_halo.py`` and ``tests/test_torch_spatial.py``:
spatially partitioned jobs on the CPU.

Started by the port's own launcher, one process a rank::

    python -c "from tpu_mednet_torch.parallel.multihost import launch_local; \
        launch_local('tests.torch_sp_ranks', ['<dir>'], 4)"

``<dir>/spec.json`` names the jobs; ``<dir>/inputs.pt`` holds their inputs
(whole volumes and global batches, the JAX package's weights carried into
the port).  Each rank joins a gloo group from the launcher's variables,
builds a 1 x 4 and a 2 x 2 (data, space) mesh, runs every job on its X
slab of its rows and saves what it got to ``<dir>/rank<r>.pt``.  Imports
torch and the port only.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

from tpu_mednet_torch.inference import predict_volume_spatial
from tpu_mednet_torch.models import ResidualUNet3D, UNet3D
from tpu_mednet_torch.ops import groupnorm as gn
from tpu_mednet_torch.ops.augment import AugmentConfig, AugmentDraws
from tpu_mednet_torch.parallel import (make_mesh, maybe_initialize_distributed, slab_plan,
                                       spatially_sharded_apply)
from tpu_mednet_torch.parallel.halo import gather_rows, halo_exchange, mirror_rows
from tpu_mednet_torch.tasks import SegmentationTask
from tpu_mednet_torch.train import OptimizerConfig, create_train_state, make_train_step
from tpu_mednet_torch.train import step as step_module

CL3D = torch.channels_last_3d
SGD = dict(name="sgd", learning_rate=0.05, momentum=0.9)
MIRROR = AugmentConfig(brightness_sigma=0.0, gamma_range=None, contrast_range=None,
                       mirror_axes=(1, 2, 3))


def _slab(mesh, x, quantum=1):
    return x[:, :, slab_plan(x.shape[2], mesh.n_space, quantum).slab(mesh.space_index)]


def _cl(x):
    return x.contiguous(memory_format=CL3D)


def _halo(meshes, inp):
    """JAX's three halo cases, a gradient through the exchange, and rows of
    uneven slabs: a halo reaching past the next slab, and the mirror."""
    mesh = meshes["1x4"]

    def conv(w):
        return lambda v: F.conv3d(v, w, padding=1)

    conv2 = conv(inp["w2"])
    out = {
        "identity": spatially_sharded_apply(lambda v: v, mesh, 2)(_slab(mesh, inp["x_id"])),
        "single": spatially_sharded_apply(conv(inp["w1"]), mesh, 1)(_slab(mesh, inp["x1"])),
        "stacked": spatially_sharded_apply(lambda v: conv2(conv2(v)), mesh, 2)(
            _slab(mesh, inp["x2"])),
        "stacked_small": spatially_sharded_apply(lambda v: conv2(conv2(v)), mesh, 1)(
            _slab(mesh, inp["x2"])),
    }
    x = _cl(_slab(mesh, inp["x1"])).requires_grad_(True)
    y = spatially_sharded_apply(conv(inp["w1"]), mesh, 1)(x)
    (y * _slab(mesh, inp["g1"])).sum().backward()
    out["grad"] = x.grad
    lengths = (24, 8, 16, 16)
    off = [0, 24, 32, 48]
    s = mesh.space_index
    mine = _cl(inp["x1"][:, :, off[s]:off[s] + lengths[s]]).requires_grad_(True)
    far = halo_exchange(mine, 12, mesh, lengths=lengths)
    (far * inp["g_far"][s]).sum().backward()
    out["far"], out["far_grad"] = far, mine.grad
    out["mirror"] = mirror_rows(mine.detach(), mesh, lengths)
    out["wide"] = gather_rows(mine.detach(), mesh, lengths,
                              [(-3, 70), (0, 64), (60, 66), (5, 9)])
    return out


def _gn(meshes, inp):
    """One GroupNorm (residual add, ELU) over 4 slabs and over 2 slabs of
    each data row: the kernels' fold-off halves (their plain versions on
    the CPU) and the sums added over the row."""
    out = {}
    for name in ("1x4", "2x2"):
        mesh = meshes[name]
        rows = mesh.rows(inp["gn_x"].shape[0])

        def local(t):
            return _cl(_slab(mesh, t[rows]))

        x, r = local(inp["gn_x"]).requires_grad_(True), local(inp["gn_r"]).requires_grad_(True)
        w = inp["gn_w"].clone().requires_grad_(True)
        b = inp["gn_b"].clone().requires_grad_(True)
        spatial = inp["gn_x"][0, 0].numel()
        y = gn.SlabGroupNormFunction.apply(x, w, b, r, 2, 1e-5, "e", mesh.space_sum_, spatial)
        y.backward(local(inp["gn_dy"]))
        out[name] = dict(y=y.detach(), dx=x.grad, dr=r.grad, dw=w.grad, db=b.grad)
        t = torch.full((3,), float(mesh.rank + 1), requires_grad=True)
        summed = mesh.all_sum(t, space=True)
        (summed * torch.arange(3.0)).sum().backward()
        out[name]["space_sum"], out[name]["space_sum_grad"] = summed.detach(), t.grad
    return out


def _losses(meshes, inp):
    """Every loss of the tasks on this rank's rows and X slab, and the
    landmark coordinate error, whose peaks are the whole volumes'."""
    from tpu_mednet_torch.ops import losses as L
    from tpu_mednet_torch.tasks.landmarks import landmark_coordinate_error

    out = {}
    for name in ("1x4", "2x2"):
        mesh = meshes[name]
        rows = mesh.rows(inp["logits"].shape[0])

        def local(t):
            return _slab(mesh, t[rows].unsqueeze(1) if t.dim() == 4 else t[rows])

        labels = local(inp["labels"])[:, 0]
        hm = local(inp["heatmaps"])
        onehot = L.expand_as_one_hot(labels, 3)
        cases = {
            "dice": lambda z: L.dice_loss(z, labels, dp=mesh),
            "ce_weighted": lambda z: L.ce_loss(z, labels, weight=[0.3, 1.0, 2.0], dp=mesh),
            "wce": lambda z: L.weighted_ce_loss(z, onehot, dp=mesh),
            "landmark": lambda z: L.multitask_landmark_loss(
                z[:, 3:], z[:, :3], labels, hm, [0.015, 0.001, 0.02], dp=mesh)[0],
            "landmark_ce_l1": lambda z: L.multitask_landmark_loss(
                z[:, 3:], z[:, :3], labels, hm, [0.015, 0.001, 0.02], class_loss="CE",
                regression_loss="L1", dp=mesh)[0],
        }
        got = {}
        for case, fn in cases.items():
            z = local(inp["logits_ldmk" if case.startswith("landmark") else "logits"])
            z = z.clone().requires_grad_(True)
            loss = fn(z)
            loss.backward()
            got[case] = (loss.detach(), z.grad)
        got["coordinate_error"] = landmark_coordinate_error(
            local(inp["logits_ldmk"])[:, :3], hm, dp=mesh)
        out[name] = got
    return out


def _residual(inp, key="residual", **kw):
    model = ResidualUNet3D(1, 2, f_maps=4, num_levels=2, num_groups=2, dtype=torch.float32,
                           device="cpu", **kw)
    model.load_state_dict(inp[key])
    return model


def _predict(meshes, inp):
    """``predict_volume_spatial`` in both modes, with TTA, and the refusal;
    the norm-free contract with its halo and a too-small one."""
    mesh = meshes["1x4"]
    task = SegmentationTask(model=_residual(inp), loss="DICE")
    out = {
        "auto64": predict_volume_spatial(task, inp["v64"].numpy(), mesh),
        "auto50": predict_volume_spatial(task, inp["v50"].numpy(), mesh),
        "tta": predict_volume_spatial(task, inp["vtta"].numpy(), mesh, tta_flips=(0, 2)),
        "tta50": predict_volume_spatial(task, inp["v50"].numpy(), mesh, tta_flips=(0, 1)),
        "explicit": predict_volume_spatial(task, inp["v64"].numpy(), mesh, mode="explicit",
                                           halo=4),
        "explicit_tta": predict_volume_spatial(task, inp["vtta"].numpy(), mesh,
                                               mode="explicit", halo=4, tta_flips=(2,)),
        "explicit_default": predict_volume_spatial(task, inp["v64"].numpy(), mesh,
                                                   mode="explicit"),
    }
    out = {k: torch.from_numpy(v) for k, v in out.items()}
    try:
        predict_volume_spatial(task, inp["v64"].numpy(), mesh, mode="explicit", halo=4,
                               tta_flips=(0,))
    except ValueError as exc:
        out["refusal"] = str(exc)
    plain = _residual(inp, key="norm_free", conv_layer_order="cr").eval()
    x = _cl(_slab(mesh, inp["contract_x"]))
    with torch.no_grad():
        for halo in (18, 2):
            out[f"contract{halo}"] = spatially_sharded_apply(plain, mesh, halo)(x)
    return out


def _steps(model, mesh, batches, optimizer, augment=None, draws=None):
    """Optimizer steps on this rank's rows and slab of each global batch
    (the train step cuts the slab); with ``draws``, the augmentation's
    draws of each step, for the global batch, instead of the generator's."""
    task = SegmentationTask(model=model, loss="DICE")
    state = create_train_state(model, optimizer=OptimizerConfig(**optimizer), seed=0)
    step = make_train_step(task, augment=augment, mesh=mesh)
    losses, grads = [], None
    queue = list(draws or [])
    real = step_module.draw_augmentations
    if draws is not None:
        step_module.draw_augmentations = lambda *a, **k: AugmentDraws(mirror=queue.pop(0))
    try:
        for batch in batches:
            rows = mesh.rows(batch["data"].shape[0])
            state, m = step(state, {k: v[rows] for k, v in batch.items()})
            losses.append(m["train_loss"])
            if grads is None:
                grads = {k: p.grad.clone() for k, p in model.named_parameters()}
    finally:
        step_module.draw_augmentations = real
    return dict(losses=torch.stack(losses), grads=grads,
                state={k: v.clone() for k, v in model.state_dict().items()})


def _train(meshes, inp):
    """The 2 x 2 step with JAX's mirror draws; an uneven plan (96 over 4
    at 5 levels); remat 1 and all against 0 under a space axis; a cbr
    UNet3D's running statistics."""
    mesh = meshes["2x2"]
    out = {"jax_mirror": _steps(_residual(inp), mesh, [inp["batch"]] * 3, optimizer=SGD,
                                augment=MIRROR, draws=inp["mirror_draws"])}
    deep = ResidualUNet3D(1, 2, f_maps=4, num_levels=5, num_groups=2, dtype=torch.float32,
                          device="cpu")
    deep.load_state_dict(inp["deep"])
    out["uneven"] = _steps(deep, meshes["1x4"], inp["deep_batches"], optimizer=SGD)
    for remat in (0, 1, True):
        out[f"remat{remat}"] = _steps(_residual(inp, remat=remat), mesh, [inp["batch"]] * 2,
                                      optimizer=SGD)
    cbr = UNet3D(1, 3, f_maps=8, num_levels=3, layer_order="cbr", dtype=torch.float32,
                 device="cpu")
    cbr.load_state_dict(inp["cbr"])
    out["cbr"] = _steps(cbr, mesh, inp["cbr_batches"], optimizer=SGD)
    return out


JOBS = {"halo": _halo, "gn": _gn, "losses": _losses, "predict": _predict, "train": _train}


def main(argv) -> int:
    root = Path(argv[0])
    spec = json.loads((root / "spec.json").read_text())
    torch.set_num_threads(1)
    assert maybe_initialize_distributed("gloo")
    meshes = {"1x4": make_mesh("cpu", n_space=4), "2x2": make_mesh("cpu", n_data=2, n_space=2)}
    inp = torch.load(root / "inputs.pt")
    out = {name: JOBS[name](meshes, inp) for name in spec["jobs"]}
    torch.save(out, root / f"rank{meshes['1x4'].rank}.pt")
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
