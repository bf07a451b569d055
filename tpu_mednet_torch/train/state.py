"""Train state: the model, its optimizer, EMA, accumulation, the generator, the step.

Counterpart of ``tpu_mednet/train/state.py``: where the JAX package
carries parameters, optax state and a PRNG key in an immutable pytree, the
port's state holds the ``nn.Module`` (parameters, updated in place), its
``torch.optim`` optimizer (built from an ``OptimizerConfig``; plain Adam,
the reference's default, segmentation.py:119-120, when none is given),
what the optax chain keeps beside it (the schedule, the count of optimizer
updates, the accumulation counter and buffers), the fp32 EMA of the
parameters when EMA is on, and one ``torch.Generator`` on the model's
device for the train step's augmentation draws.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch
from torch import nn

from tpu_mednet_torch.train.optim import OptimizerConfig, Schedule


@dataclasses.dataclass(eq=False)
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    generator: torch.Generator
    step: int = 0                      # micro-batches applied (flax ``state.step``)
    config: OptimizerConfig = OptimizerConfig()
    schedule: Optional[Schedule] = None
    updates: int = 0                   # optimizer updates (the schedule's count)
    mini_step: int = 0                 # micro-batches accumulated towards the next update
    acc_grads: Optional[List[torch.Tensor]] = None   # running mean, accumulation only
    ema: Optional[Dict[str, torch.Tensor]] = None    # fp32, keyed like the parameters

    @property
    def params(self) -> List[torch.Tensor]:
        return list(self.model.parameters())


def create_train_state(model: nn.Module, learning_rate: float = 1e-3, seed: int = 0,
                       optimizer: Optional[OptimizerConfig] = None) -> TrainState:
    """Wrap ``model`` (already initialised, on its device) with the
    optimizer of ``optimizer`` (default: Adam at ``learning_rate``), EMA
    parameters initialised to a copy of the weights when its ``ema_decay``
    is set, and a generator seeded by ``seed``."""
    cfg = optimizer if optimizer is not None else OptimizerConfig(learning_rate=learning_rate)
    device = next(model.parameters()).device
    params = list(model.parameters())
    acc = None
    if cfg.accumulate_grad_batches > 1:
        acc = [torch.zeros_like(p) for p in params]
    ema = None
    if cfg.ema_decay:
        ema = {k: p.detach().float().clone() for k, p in model.named_parameters()}
    return TrainState(model=model, optimizer=cfg.build(params),
                      generator=torch.Generator(device=device).manual_seed(seed),
                      config=cfg, schedule=cfg.make_schedule(), acc_grads=acc, ema=ema)


def param_count(state: TrainState) -> int:
    return sum(p.numel() for p in state.model.parameters())
