"""The landmark train step waits for nothing queued on the card.

A ``LandmarkTask`` at a small size (``ResidualUNet3D(1, 5)``, f_maps 8,
bf16; 32^3 patches from ``DevicePatchSampler`` over 2 subjects with 3
landmarks each, their heatmaps rendered on the card; class and regression
weights given; the landmark cell's intensity augmentation) takes one step
to warm up, then two more, each from the batch draw through the update,
under ``torch.cuda.set_sync_debug_mode("error")``: a call that makes the
host wait for the card's queue (a copy from pageable host memory, a host
read of a device value) raises there.

Marked ``cuda`` and skipped where ``torch.cuda.is_available()`` is false.
This file imports neither JAX nor tpu_mednet:

    python -m pytest --noconftest -m cuda tests/test_torch_landmark_step_cuda.py
"""

import numpy as np
import pytest
import torch

from tpu_mednet_torch.data import DevicePatchSampler, MemoryReader
from tpu_mednet_torch.models import ResidualUNet3D
from tpu_mednet_torch.ops.augment import AugmentConfig
from tpu_mednet_torch.tasks import LandmarkTask
from tpu_mednet_torch.train import create_train_state, make_train_step

SHAPES = {"s0": (40, 36, 44), "s1": (36, 44, 40)}
PATCH = (32, 32, 32)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the sync check and the kernels have no CPU mode")
    return torch.device("cuda")


def _store(seed=0):
    rng = np.random.default_rng(seed)
    store = {"images": {}, "labels": {}, "landmarks": {}}
    for key, shape in SHAPES.items():
        lbl = np.zeros((1, *shape), np.uint8)
        lbl[0, 8:24, 6:20, 10:30] = 1
        store["images"][key] = (rng.normal(size=(1, *shape)) + 2 * lbl).astype(np.float32)
        store["labels"][key] = lbl
        store["landmarks"][key] = rng.uniform(2, np.asarray(shape) - 2,
                                              size=(3, 3)).astype(np.float32)
    return store


@pytest.mark.cuda
def test_landmark_step_does_not_synchronise(cuda_device):
    model = ResidualUNet3D(1, 5, f_maps=8, dtype=torch.bfloat16, device=cuda_device)
    task = LandmarkTask(model=model, loss_regression_weight=[0.015, 0.015, 0.015],
                        loss_class_weight=[0.05, 1.0])
    state = create_train_state(model, learning_rate=1e-3, seed=0)
    step = make_train_step(task, augment=AugmentConfig())  # brightness, gamma, contrast
    sampler = DevicePatchSampler(None, list(SHAPES), 4, PATCH, reader=MemoryReader(_store()),
                                 landmark_group="landmarks", seed=1, device=cuda_device)
    batches = sampler.batches(2)
    state, metrics = step(state, next(batches))  # warm-up: the weights made on the card
    losses = [metrics["train_loss"]]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            state, metrics = step(state, next(batches))
            losses.append(metrics["train_loss"])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert all(np.isfinite(float(v)) for v in losses)
    assert state.updates == 3
