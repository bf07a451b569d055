"""Write the port's weights as a reference (midasmednet) checkpoint.

The port's counterpart of ``tpu_mednet/utils/torch_export.py:138-178``.
The port's state dicts already carry the reference model family's names
and layouts (``utils/weights.py``), so the JAX package's
``flax_to_state_dict`` has no counterpart: ``save_reference_checkpoint``
wraps a state dict in a pytorch-lightning-style ``.ckpt`` that the
reference's tooling loads (``load_from_checkpoint`` semantics,
``examples/predict.py:46-50``) and that ``model.load_state_dict`` takes.
"""

from __future__ import annotations

import argparse
import logging
from typing import Any, Dict, Mapping, Optional

import torch

logger = logging.getLogger(__name__)

__all__ = ["save_reference_checkpoint"]

# hparams of the TPU and port runtimes that the reference's model
# constructor does not read; they stay out of an exported checkpoint
PORT_ONLY_HPARAMS = frozenset({"packed", "remat", "bf16", "device_sampler", "native_loader",
                               "spatial_shards", "ckpt_format"})


def save_reference_checkpoint(
    path,
    state_dict: Mapping[str, torch.Tensor],
    hparams: Optional[Dict[str, Any]] = None,
    step: int = 0,
    epoch: int = 0,
) -> None:
    """Write a pytorch-lightning-style ``.ckpt`` the reference can load.

    The dict carries ``state_dict`` (CPU tensors: floating ones in fp32,
    BatchNorm's ``num_batches_tracked`` int64 as torch keeps it), the
    hparams as an ``argparse.Namespace`` (what PL 0.9 restores into
    ``self.hparams``, ``segmentation.py:33``) without ``PORT_ONLY_HPARAMS``,
    and ``global_step``/``epoch``.
    """
    sd = {k: v.detach().to("cpu", torch.float32 if v.is_floating_point() else v.dtype).clone()
          for k, v in state_dict.items()}
    hp = {k: v for k, v in (hparams or {}).items() if k not in PORT_ONLY_HPARAMS}
    # the reference expects an int fmaps for its 5-level net but takes
    # per-level lists (model.py:148-150): whatever was stored is kept
    torch.save(
        {
            "state_dict": sd,
            "hparams": argparse.Namespace(**hp),
            "global_step": int(step),
            "epoch": int(epoch),
        },
        path,
    )
    logger.info("wrote reference checkpoint (%d tensors, step %d) -> %s",
                len(sd), step, path)
