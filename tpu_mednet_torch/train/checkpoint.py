"""Checkpoints: save, retain, resume and load for inference.

Counterpart of ``tpu_mednet/train/checkpoint.py`` (orbax, which is
JAX-only).  A checkpoint is a directory ``<dir>/<step>/`` holding

- ``model.pt``: ``torch.save`` of the model's state dict under the
  reference's key names (what ``utils/weights.py`` produces from the JAX
  tree: the weights and BatchNorm's running statistics), and the fp32 EMA
  weights under the same names where EMA is on (parameters only, as
  JAX's ``ema_params``);
- ``train_state.pt``: the optimizer's ``state_dict`` (moments, and the
  live LR), the update count, the accumulation counter and buffers, the
  augmentation generator's state and the step;
- ``hparams.json``: the training hparams with the JAX package's keys
  (``ckpt_format`` included).

Files hold tensors and plain containers only, so ``torch.load`` reads
them with ``weights_only=True``.  A step is written into a temporary
directory that is renamed into place, so an interrupted save leaves no
readable half.  Saves are synchronous.
"""

from __future__ import annotations

import argparse
import json
import logging
import shutil
import tempfile
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import torch

from tpu_mednet_torch.train.state import TrainState

logger = logging.getLogger(__name__)

# The JAX package's checkpoint format version (tpu_mednet/train/checkpoint.py:
# 24-30), kept in the hparams side-car: 2 = the torch-phase decoder upsample.
CKPT_FORMAT = 2

_MODEL, _TRAIN, _HPARAMS = "model.pt", "train_state.pt", "hparams.json"

# directories already warned about a missing format tag (warn once each)
_format_warned: set = set()


def check_ckpt_format(hparams: Optional[Dict], directory) -> None:
    """Warn on checkpoints predating the format tag; refuse newer ones."""
    if hparams is None:
        return
    v = hparams.get("ckpt_format")
    if v is None:
        if str(directory) in _format_warned:
            return
        _format_warned.add(str(directory))
        logger.warning(
            "checkpoint at %s carries no ckpt_format tag: it predates the "
            "torch-phase decoder-upsample change (format 2). If it was "
            "trained on the old 'SAME'-padded upsample, the restored "
            "decoder will be spatially shifted by one voxel.", directory,
        )
    elif int(v) > CKPT_FORMAT:
        raise ValueError(
            f"checkpoint at {directory} has format {v}, newer than this "
            f"build's {CKPT_FORMAT}; upgrade tpu-mednet to restore it"
        )


def _jsonable(obj):
    """Best-effort conversion of an hparams namespace/dict to JSON types."""
    if hasattr(obj, "__dict__") and not isinstance(obj, dict):
        obj = vars(obj)
    return json.loads(json.dumps(obj, default=str))


def _cpu(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().cpu() for k, v in tensors.items()}


class CheckpointManager:
    """Steps in ``<directory>/<step>/``, the newest ``max_to_keep`` retained."""

    def __init__(self, directory, max_to_keep: int = 3):
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep

    def save(self, step: int, state: TrainState,
             hparams: Optional[Dict[str, Any]] = None) -> None:
        final = self.directory / str(int(step))
        if final.exists():
            raise ValueError(f"checkpoint at step {step} already exists in {self.directory}")
        tmp = Path(tempfile.mkdtemp(prefix=f".{int(step)}.", dir=self.directory))
        try:
            torch.save({"params": _cpu(state.model.state_dict()),
                        "ema": None if state.ema is None else _cpu(state.ema)},
                       tmp / _MODEL)
            torch.save({"optimizer": state.optimizer.state_dict(),
                        "step": int(state.step), "updates": int(state.updates),
                        "mini_step": int(state.mini_step),
                        "acc_grads": (None if state.acc_grads is None
                                      else [g.detach().cpu() for g in state.acc_grads]),
                        "generator": state.generator.get_state()},
                       tmp / _TRAIN)
            if hparams is not None:
                hp = _jsonable(hparams)
                hp.setdefault("ckpt_format", CKPT_FORMAT)
                (tmp / _HPARAMS).write_text(json.dumps(hp, indent=1))
            tmp.rename(final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        for old in self.available_steps[:-self.max_to_keep]:
            shutil.rmtree(self.directory / str(old))

    def wait(self) -> None:
        """Saves are synchronous: nothing is in flight."""

    @property
    def available_steps(self):
        """Sorted steps currently retained."""
        return sorted(int(p.name) for p in self.directory.iterdir()
                      if p.is_dir() and p.name.isdigit())

    @property
    def latest_step(self) -> Optional[int]:
        steps = self.available_steps
        return steps[-1] if steps else None

    def _resolve_step(self, step: Optional[int]) -> int:
        if step is not None:
            steps = self.available_steps
            if step not in steps:
                raise FileNotFoundError(
                    f"no checkpoint at step {step} in {self.directory} "
                    f"(available steps: {steps})"
                )
            return step
        step = self.latest_step
        if step is None:
            raise FileNotFoundError(f"no checkpoint found in {self.directory}")
        return step

    def _load(self, step: int, name: str) -> Dict[str, Any]:
        return torch.load(self.directory / str(step) / name, map_location="cpu",
                          weights_only=True)

    def restore_hparams(self, step: Optional[int] = None) -> Optional[Dict]:
        """The hparams side-car at ``step`` (default: latest), or None."""
        path = self.directory / str(self._resolve_step(step)) / _HPARAMS
        if not path.exists():
            return None
        hparams = json.loads(path.read_text())
        check_ckpt_format(hparams, self.directory)
        return hparams

    def restore_weights(self, step: Optional[int] = None) -> Dict[str, Any]:
        """``{"params": state dict, "ema": state dict or None}`` at ``step``."""
        return self._load(self._resolve_step(step), _MODEL)

    def restore(self, state: TrainState,
                step: Optional[int] = None) -> Tuple[TrainState, Optional[Dict]]:
        """Restore ``state`` in place at ``step`` (default: latest); returns
        ``(state, hparams)``."""
        step = self._resolve_step(step)
        weights, train = self._load(step, _MODEL), self._load(step, _TRAIN)
        if (weights["ema"] is None) != (state.ema is None):
            raise ValueError(
                f"checkpoint at step {step} in {self.directory} "
                f"{'has no' if weights['ema'] is None else 'has'} EMA weights but the "
                f"train state {'has' if state.ema is not None else 'has no'} EMA")
        if (train["acc_grads"] is None) != (state.acc_grads is None):
            raise ValueError(f"checkpoint at step {step} in {self.directory} and the "
                             "train state disagree on gradient accumulation")
        state.model.load_state_dict(weights["params"], strict=True)
        if state.ema is not None:
            for k, v in weights["ema"].items():
                state.ema[k].copy_(v)
        state.optimizer.load_state_dict(train["optimizer"])
        if state.acc_grads is not None:
            for dst, src in zip(state.acc_grads, train["acc_grads"]):
                dst.copy_(src)
        state.step, state.updates = train["step"], train["updates"]
        state.mini_step = train["mini_step"]
        state.generator.set_state(train["generator"])
        return state, self.restore_hparams(step)


def load_for_inference(path, step: Optional[int] = None, use_ema: bool = True
                       ) -> Tuple[Dict[str, torch.Tensor], Optional[Dict]]:
    """The weights to predict with and the training hparams.

    ``path`` is a checkpoint directory of the port (the EMA weights where
    the run kept them and ``use_ema``, else the raw weights; ``step``
    defaults to the latest), or a reference-style ``.ckpt`` file, as the
    JAX package's ``save_reference_checkpoint`` writes: a ``state_dict``
    under the same key names and its ``hparams`` as an
    ``argparse.Namespace``, which is allowed through ``weights_only``
    loading and nothing else is.  Returns ``(state_dict, hparams)``; the
    EMA weights come with the model's buffers (BatchNorm's running
    statistics), as JAX's ``load_for_inference`` returns ``ema_params``
    with ``batch_stats``.
    """
    p = Path(str(path))
    if p.is_file():
        if step is not None:
            raise ValueError(f"{path} is a single checkpoint file: it has no steps "
                             f"to choose from (checkpoint_step={step})")
        with torch.serialization.safe_globals([argparse.Namespace]):
            ckpt = torch.load(p, map_location="cpu", weights_only=True)
        hp = ckpt.get("hparams")
        hp = vars(hp) if isinstance(hp, argparse.Namespace) else hp
        return ckpt["state_dict"], hp
    if not p.is_dir():
        raise FileNotFoundError(f"no checkpoint directory or file at {path}")
    mgr = CheckpointManager(p)
    hp = mgr.restore_hparams(step=step)
    weights = mgr.restore_weights(step=step)
    if use_ema and weights["ema"] is not None:
        logger.info("using EMA weights from %s (ema_decay=%s)", path,
                    (hp or {}).get("ema_decay"))
        return {**weights["params"], **weights["ema"]}, hp
    return weights["params"], hp
