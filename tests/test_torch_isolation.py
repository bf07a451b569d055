"""The port stands alone: no JAX, no tpu_mednet, and no silent CPU runs.

Every module of ``tpu_mednet_torch`` is imported in a fresh interpreter,
which must then hold neither ``jax``/``flax`` nor any ``tpu_mednet``
module.  Entry points called without ``device`` mean CUDA, and raise where
there is none instead of running on the CPU.
"""

import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent


def test_port_imports_no_jax_and_no_tpu_mednet():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import tpu_mednet_torch
        names = [m.name for m in pkgutil.walk_packages(
            tpu_mednet_torch.__path__, "tpu_mednet_torch.")]
        for name in names:
            importlib.import_module(name)
        banned = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "flax", "tpu_mednet"))
        print(len(names), banned)
        sys.exit(1 if banned else 0)
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n_modules = int(proc.stdout.split()[0])
    assert n_modules >= 22


def test_port_sources_name_no_jax_import():
    """No module of the port even mentions an import of the JAX side."""
    for path in (REPO / "tpu_mednet_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            stripped = line.strip()
            if stripped.startswith(("import ", "from ")):
                mod = stripped.split()[1].split(".")[0]
                assert mod not in ("jax", "jaxlib", "flax", "tpu_mednet"), (path, line)


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is usable here")


def test_entry_points_without_device_raise_on_a_host_without_cuda(no_cuda):
    from tpu_mednet_torch import resolve_device
    from tpu_mednet_torch.data import MemoryReader
    from tpu_mednet_torch.inference import predict_volumes_on_device
    from tpu_mednet_torch.models import ResidualUNet3D
    from tpu_mednet_torch.tasks import SegmentationTask

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ResidualUNet3D(1, 2, f_maps=4, num_levels=2)
    task = SegmentationTask(model=ResidualUNet3D(1, 2, f_maps=4, num_levels=2,
                                                 device="cpu"))
    reader = MemoryReader({"images": {"s0": np.zeros((1, 8, 8, 8), np.float32)}})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        predict_volumes_on_device(task, None, ["s0"], [8, 8, 8], [2, 2, 2],
                                  reader=reader)
    from types import SimpleNamespace

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SegmentationTask.from_hparams(
            SimpleNamespace(in_channels=1, out_channels=2, fmaps=4))
    from tpu_mednet_torch.data import DevicePatchSampler

    labels = {"labels": {"s0": np.zeros((1, 8, 8, 8), np.uint8)}}
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DevicePatchSampler(None, ["s0"], 1, [4, 4, 4],
                           reader=MemoryReader({**reader.store, **labels}))


def test_kernel_wrappers_never_fall_back_for_non_cpu_tensors():
    from tpu_mednet_torch.ops import groupnorm, patches

    x = torch.empty((1, 8, 2, 2, 2), device="meta").contiguous(
        memory_format=torch.channels_last_3d)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        groupnorm.group_norm(x, 2, torch.ones(8), torch.zeros(8))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        patches.extract_patches(torch.empty((8, 8, 8, 1), device="meta"),
                                np.zeros((1, 3), np.int32), (4, 4, 4))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        groupnorm.group_norm_backward(x, x, torch.zeros(1, 8), torch.ones(1, 8),
                                      torch.ones(8), torch.zeros(8), 2)
