"""Serving export: a self-contained inference artifact via ``torch.export``.

Counterpart of ``tpu_mednet/inference/serving.py`` (``jax.export``): the
model's forward and the task's postprocess are traced by ``torch.export``
into an ``ExportedProgram`` with the trained weights baked in, saved to
one ``.pt2`` file.

Properties:

- **weights baked in**: the program's state holds them; a serving host
  needs no checkpoint and no model code;
- **symbolic batch**: exported with a symbolic leading axis
  (``torch.export.Dim``, from 1 up) by default, so one artifact serves any
  batch size, N = 1 included; ``batch_size`` pins it;
- **K1 by name**: each GroupNorm is a call of the custom ops
  ``tpu_mednet_torch::gn_moments`` and ``::gn_apply`` (``ops/groupnorm.py``),
  which run K1's CUDA kernels on the card and their plain versions on the
  CPU;
- **one device**: the program is traced on the device the model lives on
  (``platforms``, ``cuda`` or ``cpu``), which holds its weights, so one
  ``.pt2`` serves one platform; export once per platform.

**Loading needs torch and the port's op registration.**  JAX's artifact
needs only ``jax``.  This one also needs the two K1 ops registered before
``torch.export.load`` resolves them by name, so a serving host imports
``tpu_mednet_torch.ops`` (which builds the kernels at first use, and
imports no model, task, training or inference module)::

    import torch
    import tpu_mednet_torch.ops  # registers tpu_mednet_torch::gn_moments, ::gn_apply
    serve = torch.export.load("model.pt2").module()
    pred = serve(batch)   # (N, 96, 96, 96, C) float32 -> (N, 96, 96, 96, C') uint8
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

import tpu_mednet_torch.ops  # noqa: F401  (registers K1's custom ops)
from tpu_mednet_torch.inference.common import postprocess_activations, tta_split_activations

PLATFORMS = ("cuda", "cpu")


def detect_task_name(hparams) -> str:
    """'LandmarkNet' or 'SegmentationNet', from a checkpoint's hparams.

    A landmark training run always carries ``loss_regression_weight`` in
    its hparams (it defines ``num_heatmaps``, reference landmarks.py:57);
    a segmentation run never does.
    """
    hp = hparams if isinstance(hparams, dict) else vars(hparams)
    return "LandmarkNet" if hp.get("loss_regression_weight") else "SegmentationNet"


def make_serving_fn(task, tta_flips: Tuple[int, ...] = ()):
    """The (data) -> postprocessed-prediction function served at deploy time.

    ``data`` is float32 (N, X, Y, Z, C), the JAX package's layout; the
    compute-dtype cast happens inside.  Output is the task's predict
    postprocess as uint8 (N, X, Y, Z, C') — the class map, or the heatmaps
    (clipped to [0, 255]) then the class map for landmark tasks.  With
    ``tta_flips`` (spatial axes 0..2) mirror test-time augmentation is
    baked in: 2^k flipped forwards averaged in activation space before the
    argmax (``tta_split_activations`` + ``postprocess_activations``).  Call
    it under ``torch.no_grad()``.
    """
    model = task.model
    tta_flips = tuple(tta_flips)

    def serve(data: torch.Tensor) -> torch.Tensor:
        x = data.permute(0, 4, 1, 2, 3)  # logical (N, C, X, Y, Z), channels-last
        if tta_flips:
            out = postprocess_activations(task, tta_split_activations(task, x, tta_flips))
        else:
            out = task.predict_postprocess(model(x.to(model.config.dtype)))
        return out.permute(0, 2, 3, 4, 1).contiguous()

    return serve


class _Serving(torch.nn.Module):
    """The eval-mode module ``torch.export`` traces: the task's model as a
    submodule (its parameters become the artifact's weights) around
    ``make_serving_fn``."""

    def __init__(self, task, tta_flips):
        super().__init__()
        self.model = task.model
        self.serve = make_serving_fn(task, tta_flips)

    def forward(self, data: torch.Tensor) -> torch.Tensor:
        return self.serve(data)


def check_platforms(platforms: Optional[Sequence[str]]) -> Optional[str]:
    """The one platform of ``platforms`` (``None`` for none given); raises
    for ``tpu``, an unknown name, or more than one."""
    if platforms is None:
        return None
    platforms = tuple(platforms)
    if "tpu" in platforms:
        raise ValueError("--platforms tpu: this package exports for NVIDIA cards and the "
                         f"CPU ({', '.join(PLATFORMS)}); the TPU artifact is the JAX "
                         "package's (tpu_mednet.cli.export_serving)")
    unknown = [p for p in platforms if p not in PLATFORMS]
    if unknown:
        raise ValueError(f"unknown platform(s) {unknown}; choose one of {list(PLATFORMS)}")
    if len(platforms) != 1:
        raise ValueError(
            f"--platforms {' '.join(platforms)}: a .pt2 artifact is traced on one device "
            "and holds its weights there, so one file serves one platform; export once "
            "per platform")
    return platforms[0]


def export_predictor(
    task,
    patch_size: Sequence[int],
    batch_size: Optional[int] = None,
    platforms: Optional[Tuple[str, ...]] = None,
    tta_flips: Tuple[int, ...] = (),
) -> torch.export.ExportedProgram:
    """Trace the task's inference step to an ``ExportedProgram``.

    ``batch_size=None`` exports a symbolic leading axis (any N >= 1 at call
    time); an int pins it.  ``platforms`` names the one device to export
    for (``("cuda",)`` or ``("cpu",)``, default: the model's own device),
    which must be where the model's weights live.
    """
    model_dev = next(task.model.parameters()).device
    platform = check_platforms(platforms) or model_dev.type
    if platform != model_dev.type:
        raise ValueError(f"exporting for {platform} needs the model there; it is on "
                         f"{model_dev} (build the task with device={platform!r})")
    in_ch = task.model.config.in_channels
    n = 2 if batch_size is None else int(batch_size)
    example = torch.zeros((n, *(int(v) for v in patch_size), in_ch),
                          dtype=torch.float32, device=model_dev)
    dynamic = None if batch_size is not None else ({0: torch.export.Dim("batch", min=1)},)
    module = _Serving(task, tuple(tta_flips)).eval()
    with torch.no_grad():
        return torch.export.export(module, (example,), dynamic_shapes=dynamic, strict=False)


def save_exported(exported: torch.export.ExportedProgram, path) -> None:
    """Serialize an ``ExportedProgram`` to ``path`` (one ``.pt2`` file)."""
    torch.export.save(exported, str(path))


def load_exported(path) -> torch.export.ExportedProgram:
    """Deserialize a serving artifact; run it with ``loaded.module()(data)``.
    (A serving host without the rest of the port imports
    ``tpu_mednet_torch.ops`` and calls ``torch.export.load`` itself.)"""
    return torch.export.load(str(path))
