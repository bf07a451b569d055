"""Carry the JAX package's parameters into the port's modules.

Counterpart of ``tpu_mednet/utils/torch_export.py:36-135`` for the
residual family: ``state_dict_from_jax`` takes the JAX package's
``{"params": ...}`` tree (leaves as numpy arrays; packed and unpacked
models share the tree) and returns the port's state dict, whose keys are
the torch reference's.

- flax conv kernel (kD, kH, kW, I, O) -> ``Conv3d`` (O, I, kD, kH, kW);
- flax transposed kernel (kD, kH, kW, I, O) -> ``ConvTranspose3d``
  (I, O, kD, kH, kW) with the spatial flip undone (torch's transposed conv
  is the adjoint of its correlation; flax applies the kernel unflipped);
- GroupNorm ``scale``/``bias`` -> ``weight``/``bias``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn


def _conv(w) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(w, np.float32).transpose(4, 3, 0, 1, 2))


def _conv_transpose(w) -> np.ndarray:
    w = np.asarray(w, np.float32).transpose(3, 4, 0, 1, 2)
    return np.ascontiguousarray(w[:, :, ::-1, ::-1, ::-1])


def _vec(v) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(v, np.float32))


def _emit_block(out: Dict[str, np.ndarray], prefix: str, block: Mapping) -> None:
    for name, layers in sorted(block.items()):
        if not name.startswith("conv"):
            raise ValueError(f"unexpected block entry {prefix}{name!r}")
        for layer, leaves in layers.items():
            if layer == "conv":
                out[f"{prefix}{name}.conv.weight"] = _conv(leaves["kernel"])
                if "bias" in leaves:
                    out[f"{prefix}{name}.conv.bias"] = _vec(leaves["bias"])
            elif layer == "groupnorm":
                out[f"{prefix}{name}.groupnorm.weight"] = _vec(leaves["scale"])
                out[f"{prefix}{name}.groupnorm.bias"] = _vec(leaves["bias"])
            elif layer == "batchnorm":
                raise NotImplementedError("BatchNorm parameters are not ported yet")
            else:
                raise ValueError(f"unexpected layer {prefix}{name}.{layer!r}")


def state_dict_from_jax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's ``variables`` -> the port's state dict (fp32 CPU)."""
    params = variables["params"]
    if "conv3" not in params["encoder0"]["block"]:
        raise NotImplementedError("only the residual (ExtResNetBlock) family is ported")
    out: Dict[str, np.ndarray] = {}
    for name in sorted(params):
        node = params[name]
        if name == "final_conv":
            out["final_conv.weight"] = _conv(node["kernel"])
            out["final_conv.bias"] = _vec(node["bias"])
        elif name.startswith("encoder"):
            i = int(name[len("encoder"):])
            _emit_block(out, f"encoders.{i}.basic_module.", node["block"])
        elif name.startswith("decoder"):
            i = int(name[len("decoder"):])
            out[f"decoders.{i}.upsample.weight"] = _conv_transpose(node["upsample"]["kernel"])
            out[f"decoders.{i}.upsample.bias"] = _vec(node["upsample"]["bias"])
            _emit_block(out, f"decoders.{i}.basic_module.", node["block"])
        else:
            raise ValueError(f"unexpected top-level param entry {name!r}")
    return {k: torch.from_numpy(v.copy()) for k, v in out.items()}


def load_jax_params(model: nn.Module, variables: Mapping[str, Any]) -> None:
    """Strict-load the JAX package's parameters into ``model`` (any device)."""
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
