"""Train, eval and predict steps.

Counterpart of ``tpu_mednet/train/step.py``.  Where the JAX package traces
one jitted function and donates the state, the port runs the same sequence
eagerly and updates the state in place: cast to the compute dtype, augment
on the device (the spatial transform and mirror flips move the label),
forward, loss, ``backward`` (through K1's backward kernels), then the
update of ``train/optim.py``: accumulation, clipping, the schedule's LR,
the ``torch.optim`` step and the EMA.  The metrics stay device tensors, so the default step waits for
nothing.  While a profiler records, a step is traced (``utils/tracing.py``):
``train.step``, with ``train.augment``, ``train.forward_backward`` and
``train.update`` inside it.

``guard_nonfinite`` is the one exception: JAX gates the update inside the
jit with ``lax.cond``; the port computes the same finite flag on the
device and reads it on the host once per step, which only this option
pays for.

BatchNorm's running statistics (JAX's ``batch_stats``) move in the
forward, on every micro-step, as JAX's ``apply_gradients(batch_stats=...)``
moves them; a step the guard skips puts them back.

Under data parallelism (``mesh``: a ``parallel.mesh.DataMesh`` of more than
one rank) each rank steps on its rows of the global batch and the step is
the JAX package's on the whole of it, up to summation order: the
augmentation is drawn for the global batch and each rank applies its
rows' draws; the loss's batch sums and BatchNorm's statistics are
all-reduced inside autograd; the gradients are averaged over the ranks
before the update (``DataMesh.all_sum`` says why that is the gradient of
the global loss), so every rank holds the same parameters after it.

With a space axis (a mesh of ``n_data x n_space`` ranks, ``n_space`` above
1: JAX's ``train_batch_sharding`` over (data, X)) every rank of a data
row gets that row's samples at the full patch extent, augments them there
with the global batch's draws for its data index, then keeps its X slab
(``parallel.mesh.slab_plan``); the model runs on the slab through the
halo exchanges and GroupNorm's slab statistics (``models/blocks.py``),
and the loss's sums and counts, BatchNorm's and the gradients' average
go over every rank of the mesh.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from tpu_mednet_torch.models.blocks import (batch_stat_buffers, set_batch_norm_mesh,
                                            space_axis)
from tpu_mednet_torch.ops.augment import (AugmentConfig, apply_augmentations,
                                          draw_augmentations, draw_rows)
from tpu_mednet_torch.train.optim import clip_by_global_norm_, global_norm
from tpu_mednet_torch.train.state import TrainState
from tpu_mednet_torch.utils import tracing

Batch = Dict[str, torch.Tensor]


def space_slabber(model, mesh):
    """``(space, slab)`` of a step on ``mesh``: the model's ``SpaceAxis``
    (None off a space axis) and ``slab(data, label) -> (data, label)``,
    which plans the batch's X extent over the data row, points the axis at
    the plan and cuts this rank's slab (the identity off a space axis)."""
    if mesh is None or not mesh.spatial:
        return None, lambda *arrays: arrays
    from tpu_mednet_torch.parallel.halo import SpaceAxis
    from tpu_mednet_torch.parallel.mesh import slab_plan

    space = SpaceAxis(mesh)
    quantum = 2 ** (len(model.config.feature_maps) - 1)

    def slab(*arrays):
        space.plan = slab_plan(arrays[0].shape[2], mesh.n_space, quantum)
        rows = space.plan.slab(mesh.space_index)
        return tuple(a[:, :, rows] for a in arrays)

    return space, slab


def all_finite(loss: torch.Tensor, grads) -> torch.Tensor:
    """Device bool: the loss and every gradient element are finite (a max
    |g| is finite exactly when every element is)."""
    peaks = torch.stack(torch._foreach_norm(grads, float("inf")))
    return torch.isfinite(loss) & torch.isfinite(peaks).all()


def apply_gradients(state: TrainState, ema_decay: float = 0.0,
                    grad_norm: Optional[torch.Tensor] = None) -> bool:
    """One micro-step of the optimizer chain on the parameters' ``.grad``,
    in optax's order: accumulate (``MultiSteps``: the running mean, applied
    on the k-th micro-step), clip by global norm, the LR of the schedule at
    the update count, the optimizer step, then the EMA, which advances
    only when the parameters did.  Returns whether they did."""
    cfg = state.config
    grads = [p.grad for p in state.params]
    state.step += 1
    if state.acc_grads is not None:
        n = state.mini_step
        delta = torch._foreach_sub(grads, state.acc_grads)
        torch._foreach_div_(delta, float(n + 1))
        torch._foreach_add_(state.acc_grads, delta)
        state.mini_step = (n + 1) % cfg.accumulate_grad_batches
        if state.mini_step:
            return False
        torch._foreach_copy_(grads, state.acc_grads)
        torch._foreach_zero_(state.acc_grads)
        grad_norm = None  # the norm of the mean, not of this micro-batch
    if cfg.grad_clip_norm > 0:
        clip_by_global_norm_(grads, cfg.grad_clip_norm, grad_norm)
    if cfg.schedule != "plateau":
        lr = state.schedule(state.updates)
        for group in state.optimizer.param_groups:
            group["lr"] = lr
    state.optimizer.step()
    state.updates += 1
    if ema_decay:
        ema = list(state.ema.values())
        torch._foreach_mul_(ema, ema_decay)
        torch._foreach_add_(ema, [p.detach() for p in state.params], alpha=1.0 - ema_decay)
    return True


def make_train_step(task, augment: Optional[AugmentConfig] = None,
                    ema_decay: float = 0.0, guard_nonfinite: bool = False,
                    track_grad_norm: bool = False, mesh=None
                    ) -> Callable[[TrainState, Batch], Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """The train step for ``task``: ``step(state, batch) -> (state, metrics)``
    with ``metrics["train_loss"]`` (the reference's scalar,
    segmentation.py:64) as a device tensor.  The step trains
    ``state.model``; ``task`` gives the loss.

    ``ema_decay`` > 0 keeps ``state.ema`` as ``decay * ema + (1 - decay) *
    params`` after every real optimizer update (the state must come from a
    config with EMA on).  ``track_grad_norm`` adds ``grad_norm``, the
    pre-clip global L2 norm of this micro-batch's gradients.
    ``guard_nonfinite`` adds ``nonfinite`` (0/1) and, where the loss or any
    gradient is non-finite, skips the optimizer, the EMA, accumulation and
    the step count, and restores BatchNorm's running statistics; the
    augmentation draws have advanced the generator either way.  With a
    ``mesh`` of more than one rank, ``batch`` holds this rank's rows of
    the global batch (its data index's, at the full patch extent, on a
    space axis) and the step is data-parallel, or spatially partitioned
    (module docstring); the metrics are the global batch's.
    """
    if ema_decay and not (0.0 < ema_decay < 1.0):
        raise ValueError(f"ema_decay must be in (0, 1), got {ema_decay}")
    dp = mesh if mesh is not None and mesh.parallel else None
    space, slab = space_slabber(task.model, mesh)

    def step(state: TrainState, batch: Batch):
        with tracing.span("train.step"):
            if ema_decay and state.ema is None:
                raise ValueError("ema_decay is set but the train state holds no EMA: "
                                 "create it from an OptimizerConfig with ema_decay")
            model = state.model
            model.train()
            with tracing.span("train.augment"):
                data = batch["data"].to(model.config.dtype)
                label = batch["label"]
                if augment is not None:
                    draws = None
                    if dp is not None:
                        n = data.shape[0]
                        draws = draw_rows(draw_augmentations(augment, (n * dp.n_data,
                                                                       *data.shape[1:]),
                                                             state.generator),
                                          dp.rows(n * dp.n_data))
                    data, label = apply_augmentations(data, augment, state.generator,
                                                      label=label, draws=draws)
                data, label = slab(data, label)
            with tracing.span("train.forward_backward"):
                stats = batch_stat_buffers(model) if guard_nonfinite else []
                saved = [t.clone() for t in stats]
                set_batch_norm_mesh(model, dp)
                with space_axis(model, space):  # through the backward: remat runs the stages again
                    outputs = model(data)
                    loss, aux = task.loss_fn(outputs, {"data": data, "label": label}, dp=dp)
                    state.optimizer.zero_grad(set_to_none=True)
                    loss.backward()
                if dp is not None:
                    dp.average_gradients([p.grad for p in state.params])
                loss = loss.detach()
                metrics = {"train_loss": loss, **{k: v.detach() for k, v in aux.items()}}
            with tracing.span("train.update"):
                norm = None
                if track_grad_norm:
                    norm = metrics["grad_norm"] = global_norm([p.grad for p in state.params])
                if guard_nonfinite:
                    finite = all_finite(loss, [p.grad for p in state.params])
                    metrics["nonfinite"] = (~finite).float()
                    if not bool(finite):  # the guard's host read
                        if stats:
                            torch._foreach_copy_(stats, saved)
                        return state, metrics
                apply_gradients(state, ema_decay, norm)
            return state, metrics

    return step


def _forward(model, data: torch.Tensor, weights: Optional[Dict[str, torch.Tensor]]):
    if weights is None:
        return model(data)
    return torch.func.functional_call(model, weights, (data,))


def make_eval_step(task, use_ema: bool = False, mesh=None
                   ) -> Callable[[TrainState, Batch], Dict[str, torch.Tensor]]:
    """The validation step: ``state.model``'s forward in eval mode without
    gradients (on ``state.ema`` with ``use_ema`` where the state has one;
    the EMA covers the parameters, and BatchNorm uses the model's running
    statistics, as JAX's does), then the task's ``val_metrics``
    (``val_loss``, ``val_dice{c}``) as device tensors.  With a ``mesh`` of
    more than one rank the metrics' batch sums are all-reduced before their
    divisions, so every rank holds the global batch's metrics, as JAX's
    sharded eval step gives them; on a space axis each rank runs its X
    slab of its data index's rows, as the train step does."""
    dp = mesh if mesh is not None and mesh.parallel else None
    space, slab = space_slabber(task.model, mesh)

    def step(state: TrainState, batch: Batch) -> Dict[str, torch.Tensor]:
        model = state.model
        model.eval()
        weights = state.ema if use_ema else None
        with torch.inference_mode(), space_axis(model, space):
            data, label = slab(batch["data"].to(model.config.dtype), batch["label"])
            outputs = _forward(model, data, weights)
            return task.val_metrics(outputs, {"data": data, "label": label}, dp=dp)

    return step


def make_predict_step(task, tta_flips=()) -> Callable[[torch.Tensor], torch.Tensor]:
    """Inference step: the task model's forward in eval mode, then the
    task's postprocess (``tpu_mednet/train/step.py:169-192``).  With
    ``tta_flips`` (spatial axes 0..2), mirror TTA averages 2^k flipped
    forwards in activation space before the argmax
    (``inference/common.py``).  Takes (N, C, X, Y, Z) data on the model's
    device."""
    from tpu_mednet_torch.inference.common import (postprocess_activations,
                                                   tta_split_activations)

    model = task.model
    tta_flips = tuple(tta_flips)

    def step(data: torch.Tensor) -> torch.Tensor:
        model.eval()
        with torch.inference_mode():
            if tta_flips:
                return postprocess_activations(
                    task, tta_split_activations(task, data, tta_flips))
            return task.predict_postprocess(model(data.to(model.config.dtype)))

    return step
