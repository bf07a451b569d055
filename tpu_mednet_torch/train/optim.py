"""Optimizer and LR-schedule configuration of the training runtime.

The port's counterpart of ``tpu_mednet/train/optim.py``: one declarative
``OptimizerConfig`` (adam/adamw/sgd, coupled L2 for sgd, global-norm
clipping, constant/cosine/linear/poly/step/plateau schedules with linear
warmup, gradient accumulation, weight EMA) with the JAX package's fields,
checks and ``signature``.  It builds a ``torch.optim`` optimizer; the train
step (``train/step.py``) does what the optax chain does around it, in
optax's order and with optax's rules:

- accumulation as ``optax.MultiSteps``: the running mean of k micro-batch
  gradients, ``acc + (g - acc) / (n + 1)``, applied on the k-th;
- clipping as ``optax.clip_by_global_norm``: scale by ``max / norm`` only
  where ``norm >= max`` (not ``clip_grad_norm_``'s ``max / (norm + 1e-6)``),
  by a device scalar, so no host read;
- the schedule as a plain-Python function of the count of optimizer
  updates so far, evaluated *before* the count advances (a warmup's first
  update has lr 0), written into the optimizer's ``param_groups``; plateau
  instead keeps the live LR in ``param_groups``, so checkpoints carry it.

The update rules themselves are ``torch.optim``'s: Adam's and AdamW's equal
optax's up to rounding order, SGD's momentum buffer equals optax's trace.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Iterable, Optional

import numpy as np
import torch

Schedule = Callable[[int], float]

_OPTIMIZERS = ("adam", "adamw", "sgd")
_SCHEDULES = ("constant", "cosine", "linear", "poly", "step", "plateau")


def _linear(init: float, end: float, steps: int) -> Schedule:
    """``optax.linear_schedule``: init -> end over ``steps``, then end."""
    steps = max(int(steps), 1)
    return lambda count: (init - end) * (1 - min(max(count, 0), steps) / steps) + end


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """Declarative optimizer + schedule description.

    ``total_steps == 0`` means "fill in from the run length" — the Trainer
    substitutes ``steps_per_epoch * max_epochs`` before building.
    """

    name: str = "adam"
    learning_rate: float = 1e-3
    weight_decay: float = 0.0          # decoupled (adamw); L2-coupled for sgd
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    momentum: float = 0.9              # sgd only
    nesterov: bool = False             # sgd only
    grad_clip_norm: float = 0.0        # 0 = off
    schedule: str = "constant"
    warmup_steps: int = 0
    total_steps: int = 0               # cosine/linear/poly horizon
    end_lr_factor: float = 0.0         # final lr = learning_rate * factor
    poly_power: float = 0.9
    lr_decay_every: int = 0            # step schedule: steps between decays
    lr_decay_rate: float = 0.1         # step schedule: multiplicative factor
    accumulate_grad_batches: int = 1   # PL accumulate_grad_batches parity
    ema_decay: float = 0.0             # weight EMA (0 = off; e.g. 0.999)
    lr_plateau_factor: float = 0.1     # plateau: multiply lr by this
    lr_plateau_patience: int = 10      # plateau: stale val checks before decay
    lr_plateau_min_delta: float = 0.0  # plateau: improvement threshold
    min_lr: float = 0.0                # plateau: floor

    def __post_init__(self):
        if self.name not in _OPTIMIZERS:
            raise ValueError(
                f"unknown optimizer {self.name!r} (one of {_OPTIMIZERS})"
            )
        if self.schedule not in _SCHEDULES:
            raise ValueError(
                f"unknown lr schedule {self.schedule!r} (one of {_SCHEDULES})"
            )
        if self.schedule == "step" and self.lr_decay_every <= 0:
            raise ValueError(
                "--lr_schedule step requires --lr_decay_every > 0"
            )
        if self.accumulate_grad_batches < 1:
            raise ValueError("--accumulate_grad_batches must be >= 1")
        if self.ema_decay and not (0.0 < self.ema_decay < 1.0):
            raise ValueError(
                f"--ema_decay must be in (0, 1), got {self.ema_decay}"
            )
        if self.schedule == "plateau":
            if self.warmup_steps:
                raise ValueError(
                    "--lr_schedule plateau does not compose with "
                    "--warmup_steps (plateau IS the schedule: the LR only "
                    "moves on validation plateaus)"
                )
            if not (0.0 < self.lr_plateau_factor < 1.0):
                raise ValueError(
                    "--lr_plateau_factor must be in (0, 1), got "
                    f"{self.lr_plateau_factor}"
                )
            if self.lr_plateau_patience < 1:
                raise ValueError("--lr_plateau_patience must be >= 1")
        if self.name == "adam" and self.weight_decay:
            raise ValueError(
                "--weight_decay with --optimizer adam is silently ignored "
                "by torch semantics people usually don't want; use adamw "
                "(decoupled) or sgd (L2-coupled)"
            )

    @classmethod
    def from_hparams(cls, hparams) -> "OptimizerConfig":
        """Build from a parsed CLI namespace (missing flags -> defaults)."""
        hp = vars(hparams) if not isinstance(hparams, dict) else hparams
        fields = {f.name for f in dataclasses.fields(cls)}
        alias = {"optimizer": "name", "lr_schedule": "schedule"}
        kwargs = {}
        for key, value in hp.items():
            key = alias.get(key, key)
            if key in fields and value is not None:
                kwargs[key] = value
        return cls(**kwargs)

    # -- schedule ----------------------------------------------------------

    def needs_total_steps(self) -> bool:
        return self.schedule in ("cosine", "linear", "poly")

    def resolve_total_steps(self, total_micro_steps: int) -> "OptimizerConfig":
        """Fill ``total_steps`` from the run length when left at 0.

        ``total_micro_steps`` is the run's batch count; schedules run in
        optimizer steps, which advance once per ``accumulate_grad_batches``
        micro-batches.
        """
        if self.total_steps or not self.needs_total_steps():
            return self
        total = max(int(total_micro_steps) // self.accumulate_grad_batches, 1)
        return dataclasses.replace(self, total_steps=total)

    def make_schedule(self) -> Schedule:
        """The LR as a function of the count of optimizer updates so far,
        the closed forms of the optax schedules the JAX package composes
        (``constant_schedule``, ``cosine_decay_schedule``,
        ``linear_schedule``, ``polynomial_schedule``, staircase
        ``exponential_decay``, ``join_schedules`` after a linear warmup)."""
        lr, end = self.learning_rate, self.learning_rate * self.end_lr_factor
        decay_steps = max(self.total_steps - self.warmup_steps, 1)
        if self.needs_total_steps() and not self.total_steps:
            raise ValueError(f"{self.schedule} schedule needs total_steps")
        if self.schedule in ("constant", "plateau"):
            # plateau has no closed form (the Trainer rewrites the live LR on
            # validation plateaus); report the initial LR
            base = lambda count: lr
        elif self.schedule == "cosine":
            alpha = self.end_lr_factor

            def base(count):
                frac = min(max(count, 0), decay_steps) / decay_steps
                return lr * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * frac)) + alpha)
        elif self.schedule == "linear":
            base = _linear(lr, end, decay_steps)
        elif self.schedule == "poly":
            power = self.poly_power

            def base(count):
                frac = 1 - min(max(count, 0), decay_steps) / decay_steps
                return (lr - end) * frac**power + end
        else:  # step
            every, rate = self.lr_decay_every, self.lr_decay_rate
            base = lambda count: lr * rate ** (max(count, 0) // every)
        if self.warmup_steps:
            warmup, w = _linear(0.0, lr, self.warmup_steps), self.warmup_steps
            return lambda count: warmup(count) if count < w else base(count - w)
        return base

    def lr_at(self, state_step: int) -> float:
        """LR at a train state's ``step`` (micro-batch count) — for logging."""
        return float(self.make_schedule()(int(state_step) // self.accumulate_grad_batches))

    # -- optimizer ---------------------------------------------------------

    def _is_stateful_schedule(self) -> bool:
        return not (self.schedule in ("constant", "plateau")
                    and not self.warmup_steps)

    def build(self, params: Iterable[torch.Tensor]) -> torch.optim.Optimizer:
        """The ``torch.optim`` optimizer of this config over ``params``.

        Its LR is the schedule's value at count 0; the train step rewrites
        it before each update (except under plateau)."""
        params = list(params)
        lr = self.make_schedule()(0)
        if self.schedule == "plateau":
            # the live LR is float32 in the JAX package's optimizer state
            lr = float(np.float32(lr))
        betas = (self.beta1, self.beta2)
        if self.name == "adam":
            return torch.optim.Adam(params, lr=lr, betas=betas, eps=self.eps)
        if self.name == "adamw":
            return torch.optim.AdamW(params, lr=lr, betas=betas, eps=self.eps,
                                     weight_decay=self.weight_decay)
        return torch.optim.SGD(params, lr=lr, momentum=self.momentum,
                               nesterov=self.nesterov, weight_decay=self.weight_decay)

    def signature(self) -> dict:
        """What shapes the optimizer state, for resume compatibility.

        Two configs with equal signatures restore into each other's
        checkpoints (values like the LR or decay rate may differ; the
        structure does not).  The keys are the JAX package's, so both
        packages refuse the same resumes.
        """
        return {
            "optimizer": self.name,
            "grad_clip": bool(self.grad_clip_norm > 0),
            "accumulate_grad_batches": int(self.accumulate_grad_batches),
            "stateful_schedule": self._is_stateful_schedule(),
            "ema": bool(self.ema_decay),
            "plateau": self.schedule == "plateau",
            "sgd_weight_decay": bool(
                self.name == "sgd" and self.weight_decay
            ),
            "sgd_momentum": bool(self.name == "sgd" and self.momentum),
        }


def global_norm(tensors) -> torch.Tensor:
    """``optax.global_norm``: the L2 norm of all the tensors together, as a
    device scalar."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


def clip_by_global_norm_(grads, max_norm: float, norm: Optional[torch.Tensor] = None) -> None:
    """``optax.clip_by_global_norm`` in place: scale by ``max_norm / norm``
    where ``norm >= max_norm``, else leave the gradients as they are."""
    norm = global_norm(grads) if norm is None else norm
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(grads, scale)


class PlateauController:
    """ReduceLROnPlateau: decay the live LR on validation plateaus.

    Host-side mirror of ``torch.optim.lr_scheduler.ReduceLROnPlateau``
    (mode='min'), as in the JAX package: after ``patience`` consecutive val
    checks without a ``> min_delta`` improvement of the monitored value,
    the optimizer's LR is multiplied by ``factor``, floored at ``min_lr``,
    and the stale counter resets.  The LR lives in the optimizer's
    ``param_groups``, which checkpoints carry, so a resumed run keeps its
    decayed value; the counter restarts on resume.  Values are rounded to
    float32, as the JAX package's LR leaf is.
    """

    def __init__(self, cfg: OptimizerConfig):
        if cfg.schedule != "plateau":
            raise ValueError("PlateauController needs schedule='plateau'")
        self.cfg = cfg
        self._best: Optional[float] = None
        self._stale = 0

    def update(self, optimizer: torch.optim.Optimizer, value: float) -> Optional[float]:
        """Feed one monitored value; returns the new LR, or None."""
        if self._best is None or \
                value < self._best - self.cfg.lr_plateau_min_delta:
            self._best = float(value)
            self._stale = 0
            return None
        self._stale += 1
        if self._stale < self.cfg.lr_plateau_patience:
            return None
        self._stale = 0
        current = float(optimizer.param_groups[0]["lr"])
        new_lr = max(current * self.cfg.lr_plateau_factor, self.cfg.min_lr)
        if new_lr >= current * (1.0 - 1e-6):  # already at the floor
            return None
        new_lr = float(np.float32(new_lr))
        for group in optimizer.param_groups:
            group["lr"] = new_lr
        return new_lr


def read_current_lr(cfg: OptimizerConfig, optimizer: torch.optim.Optimizer,
                    state_step: int) -> float:
    """The LR in effect now — plateau reads the live value, others compute."""
    if cfg.schedule == "plateau":
        return float(optimizer.param_groups[0]["lr"])
    return cfg.lr_at(state_step)


def check_resume_optimizer(hp_prev: dict, cfg: OptimizerConfig,
                           resume) -> None:
    """Refuse a --resume whose optimizer state cannot hold ours.

    Reads the optimizer-shaped keys of the checkpoint's hparams side-car
    and compares signatures; side-cars without any of the keys are the
    historic plain-Adam configuration.
    """
    keys = ("optimizer", "lr_schedule", "warmup_steps", "grad_clip_norm",
            "accumulate_grad_batches", "weight_decay", "momentum",
            "ema_decay", "lr_decay_every")
    if not any(k in hp_prev for k in keys):
        prev = OptimizerConfig()  # pre-flag checkpoint: plain Adam
    else:
        prev = OptimizerConfig.from_hparams(
            {k: hp_prev[k] for k in keys if k in hp_prev}
        )
    ours, theirs = cfg.signature(), prev.signature()
    if ours != theirs:
        diffs = [f"{k}: checkpoint {theirs[k]} vs CLI {ours[k]}"
                 for k in ours if ours[k] != theirs[k]]
        raise ValueError(
            f"--resume {resume}: the checkpoint's optimizer state has a "
            f"different structure ({'; '.join(diffs)}). Pass matching "
            "--optimizer/--lr_schedule/--grad_clip_norm/"
            "--accumulate_grad_batches, or start a fresh run."
        )
