"""Train state: the model, its optimizer, the augmentation generator, the step.

Counterpart of ``tpu_mednet/train/state.py``: where the JAX package
carries parameters, optimizer state and a PRNG key in an immutable pytree,
the port's state holds the ``nn.Module`` (parameters, updated in place),
its ``torch.optim`` optimizer (Adam, the reference's default,
segmentation.py:119-120), and one ``torch.Generator`` on the model's
device for the train step's augmentation draws.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn


@dataclasses.dataclass(eq=False)
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    generator: torch.Generator
    step: int = 0


def create_train_state(model: nn.Module, learning_rate: float, seed: int = 0,
                       optimizer: Optional[torch.optim.Optimizer] = None) -> TrainState:
    """Wrap ``model`` (already initialised, on its device) with Adam at
    ``learning_rate`` (or ``optimizer``) and a generator seeded by ``seed``."""
    device = next(model.parameters()).device
    if optimizer is None:
        optimizer = torch.optim.Adam(model.parameters(), lr=learning_rate)
    generator = torch.Generator(device=device).manual_seed(seed)
    return TrainState(model=model, optimizer=optimizer, generator=generator)


def param_count(state: TrainState) -> int:
    return sum(p.numel() for p in state.model.parameters())
