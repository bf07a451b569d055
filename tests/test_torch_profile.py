"""The Trainer's profiler hook (``profile_dir``, ``profile_steps``), on the CPU.

The counterpart of the JAX Trainer's ``jax.profiler`` window: steps 1 to
``profile_steps`` of epoch 0 are traced with ``torch.profiler`` into one
Chrome trace under ``profile_dir``, each step under the program's own span
(``utils/tracing.py``: ``tpu_mednet_torch.train.step`` in the trace).  Held here: the trace holds those steps and K1's
autograd Function by name, nothing is written without ``profile_dir``, a window the
epoch cuts short is closed at its end, and the step losses are the
unprofiled run's, bit for bit.
"""

import json

import numpy as np
import pytest
import torch

from tests.test_torch_native_loader import build_sampler
from tpu_mednet_torch.models import ResidualUNet3D
from tpu_mednet_torch.tasks import SegmentationTask
from tpu_mednet_torch.train import Trainer
from tpu_mednet_torch.utils import tracing

STEP_SPAN = tracing.PREFIX + "train.step"


def _fit(profile_dir=None, profile_steps=5, limit=4):
    """Per-step losses of one epoch of ``limit`` steps from fixed weights."""
    torch.manual_seed(0)
    model = ResidualUNet3D(2, 3, f_maps=4, num_levels=2, dtype=torch.float32, device="cpu",
                           generator=torch.Generator().manual_seed(0))
    trainer = Trainer(SegmentationTask(model=model), build_sampler(), batch_size=2,
                      max_epochs=1, limit_train_batches=limit, profile_dir=profile_dir,
                      profile_steps=profile_steps)
    losses, step = [], trainer.train_step

    def recorded(state, arrays):
        state, metrics = step(state, arrays)
        losses.append(float(metrics["train_loss"]))
        return state, metrics

    trainer.train_step = recorded
    trainer.fit()
    return losses


def _trace_names(path):
    events = json.loads(path.read_text())["traceEvents"]
    return [e.get("name", "") for e in events]


def test_profile_window_traces_steps_and_keeps_losses(tmp_path):
    plain = _fit()
    profiled = _fit(tmp_path / "prof", profile_steps=2)
    assert len(plain) == 4 and profiled == plain
    (trace,) = (tmp_path / "prof").iterdir()
    assert trace.name == "train_steps_1-2.pt.trace.json"
    names = _trace_names(trace)
    assert names.count(STEP_SPAN) == 2  # steps 1 and 2, not 0 or 3
    # K1 under autograd, forward and backward (on the card the trace also
    # names its kernels)
    assert "GroupNormFunction" in names and "GroupNormFunctionBackward" in names


def test_no_profile_dir_writes_nothing(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    started = []
    monkeypatch.setattr(torch.profiler.profile, "start",
                        lambda self: started.append(self))
    _fit(profile_dir=None, profile_steps=2)
    assert not started and not list(tmp_path.iterdir())


def test_profile_window_closed_at_epoch_end(tmp_path, caplog):
    """``profile_steps`` beyond the epoch: the trace is closed and written
    when the epoch ends, with a warning."""
    with caplog.at_level("WARNING", logger="tpu_mednet_torch.train.loop"):
        _fit(tmp_path / "prof", profile_steps=10, limit=3)
    assert "profile trace closed at epoch end after 3 steps" in caplog.text
    (trace,) = (tmp_path / "prof").iterdir()
    assert trace.name == "train_steps_1-2.pt.trace.json"
    assert _trace_names(trace).count(STEP_SPAN) == 2
    assert np.isfinite(_fit(limit=3)).all()
