"""Train and eval steps: augment, forward, loss, backward, optimizer update.

Counterpart of ``tpu_mednet/train/step.py:26-166``.  Where the JAX package
traces one jitted function and donates the state, the port runs the same
sequence eagerly and updates the state in place: cast to the compute
dtype, augment on the device (mirror flips move the label), forward,
loss, ``backward`` (through K1's backward kernels), optimizer step.  The
metrics stay device tensors: nothing here waits for the card.

EMA, the non-finite guard and the gradient norm are not ported yet.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from tpu_mednet_torch.ops.augment import AugmentConfig, apply_augmentations
from tpu_mednet_torch.train.state import TrainState

Batch = Dict[str, torch.Tensor]


def make_train_step(task, augment: Optional[AugmentConfig] = None,
                    ema_decay: float = 0.0, guard_nonfinite: bool = False,
                    track_grad_norm: bool = False
                    ) -> Callable[[TrainState, Batch], Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """The train step for ``task``: ``step(state, batch) -> (state, metrics)``
    with ``metrics["train_loss"]`` (the reference's scalar, segmentation.py:64)
    as a device tensor.  The step trains ``state.model``; ``task`` gives the
    loss."""
    if ema_decay or guard_nonfinite or track_grad_norm:
        raise NotImplementedError("ema_decay, guard_nonfinite and track_grad_norm "
                                  "are not ported yet")

    def step(state: TrainState, batch: Batch):
        model = state.model
        model.train()
        data = batch["data"].to(model.config.dtype)
        label = batch["label"]
        if augment is not None:
            data, label = apply_augmentations(data, augment, state.generator, label=label)
        outputs = model(data)
        loss, aux = task.loss_fn(outputs, {"data": data, "label": label})
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return state, {"train_loss": loss.detach(), **{k: v.detach() for k, v in aux.items()}}

    return step


def make_eval_step(task) -> Callable[[TrainState, Batch], Dict[str, torch.Tensor]]:
    """The validation step: ``state.model``'s forward without gradients, then
    the task's ``val_metrics`` (``val_loss``, ``val_dice{c}``) as device
    tensors."""

    def step(state: TrainState, batch: Batch) -> Dict[str, torch.Tensor]:
        model = state.model
        model.eval()
        with torch.inference_mode():
            data = batch["data"].to(model.config.dtype)
            outputs = model(data)
            return task.val_metrics(outputs, {"data": data, "label": batch["label"]})

    return step
