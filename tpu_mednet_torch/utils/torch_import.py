"""Read reference (midasmednet) checkpoints into the port.

The port's counterpart of ``tpu_mednet/utils/torch_import.py:191-315``.
Reference users carry pytorch-lightning checkpoints
(``examples/train_seg.py:122-131``'s default checkpointing) or bare
``torch.save(model.state_dict())`` files of the reference model family
(``midasmednet/unet/model.py:11-213``).  The port's modules carry the
reference's parameter names and layouts (``utils/weights.py``), so a
reference ``state_dict`` loads into them as it is: the JAX package's
``convert_state_dict`` (torch layout -> flax tree) has no counterpart
here.  What is kept:

- ``infer_architecture``: the family (``residual`` or ``double``), the
  channel counts and the per-level widths, from the weights' shapes alone;
- ``load_torch_checkpoint``: the weights, the hparams (PL 0.9's
  ``hparams`` Namespace or a later ``hyper_parameters`` dict) and the
  ``global_step`` of a ``.ckpt``, or a bare state dict; a ``model.``
  prefix is stripped;
- ``check_against_template``: every key and shape of a state dict against
  the port model's own ``state_dict`` (a model built on the ``meta``
  device holds no weights), so an import is total or refused.

``load_torch_checkpoint`` loads with ``weights_only=False``: a PL
checkpoint pickles an ``argparse.Namespace`` and may hold other objects,
and unpickling can run arbitrary code — only import checkpoints you trust.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Mapping, Optional, Tuple

import torch

logger = logging.getLogger(__name__)

__all__ = ["check_against_template", "infer_architecture", "load_torch_checkpoint"]


def infer_architecture(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    """Derive the model architecture from state_dict shapes alone.

    Returns ``{family, in_channels, out_channels, f_maps, num_levels}``
    where family is 'residual' (ExtResNetBlock tree, ``conv1..3``) or
    'double' (DoubleConv tree, ``SingleConv1..2``).  Values may be tensors
    or numpy arrays.
    """
    keys = set(state_dict)
    if "encoders.0.basic_module.conv1.conv.weight" in keys:
        family, first = "residual", "encoders.{i}.basic_module.conv1.conv.weight"
    elif "encoders.0.basic_module.SingleConv1.conv.weight" in keys:
        family, first = "double", "encoders.{i}.basic_module.SingleConv1.conv.weight"
    else:
        raise ValueError(
            "state_dict is not a midasmednet UNet3D/ResidualUNet3D: missing "
            "encoders.0.basic_module.{conv1|SingleConv1}.conv.weight"
        )
    n_levels = 0
    while first.format(i=n_levels) in keys:
        n_levels += 1
    in_channels = int(state_dict[first.format(i=0)].shape[1])
    # per-level output channels: the LAST conv of each encoder block
    last = "conv3" if family == "residual" else "SingleConv2"
    f_maps = tuple(
        int(state_dict[f"encoders.{i}.basic_module.{last}.conv.weight"].shape[0])
        for i in range(n_levels)
    )
    return {
        "family": family,
        "in_channels": in_channels,
        "out_channels": int(state_dict["final_conv.weight"].shape[0]),
        "f_maps": f_maps,
        "num_levels": n_levels,
    }


def load_torch_checkpoint(path) -> Tuple[Dict[str, torch.Tensor], Optional[Dict[str, Any]], int]:
    """Load a PL checkpoint or a bare state_dict file.

    Returns ``(state_dict, hparams_dict_or_None, global_step)``, the state
    dict's values as CPU tensors.  PL 0.9 stores the weights under
    ``state_dict`` and the argparse namespace under ``hparams`` (later PL
    versions: ``hyper_parameters``); a raw ``torch.save(model.state_dict())``
    file has neither.  Trusted files only (``weights_only=False``).
    """
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    hparams: Optional[Dict[str, Any]] = None
    step = 0
    if isinstance(ckpt, dict) and "state_dict" in ckpt:
        sd = ckpt["state_dict"]
        hp = ckpt.get("hparams", ckpt.get("hyper_parameters"))
        if hp is not None:
            hparams = dict(vars(hp)) if not isinstance(hp, dict) else dict(hp)
        step = int(ckpt.get("global_step", 0) or 0)
    else:
        sd = ckpt
    out = {}
    for k, v in sd.items():
        # the reference's tasks subclass the model, so keys carry no prefix
        # (segmentation.py:22, landmarks.py:22); a wrapped export's may
        k = k[len("model."):] if k.startswith("model.") else k
        out[k] = v.detach().cpu() if isinstance(v, torch.Tensor) else torch.as_tensor(v)
    return out, hparams, step


def check_against_template(state_dict: Mapping[str, Any],
                           template: Mapping[str, Any]) -> None:
    """Raise unless ``state_dict`` has exactly ``template``'s keys and
    shapes (``template``: a model's ``state_dict()``, on ``meta`` or any
    device).  Every missing, extra or mis-shaped entry is named: an import
    is total, not best-effort."""
    missing = sorted(set(template) - set(state_dict))
    extra = sorted(set(state_dict) - set(template))
    if missing or extra:
        raise ValueError(
            f"params tree mismatch — missing from checkpoint: {missing}; "
            f"unexpected in checkpoint: {extra}"
        )
    bad = [
        f"{k}: checkpoint {tuple(state_dict[k].shape)} vs model {tuple(template[k].shape)}"
        for k in template
        if tuple(state_dict[k].shape) != tuple(template[k].shape)
    ]
    if bad:
        raise ValueError("params shape mismatches — " + "; ".join(bad))
