"""Carry the JAX package's parameters into the port's modules.

Counterpart of ``tpu_mednet/utils/torch_export.py:36-135``:
``state_dict_from_jax`` takes the JAX package's ``{"params": ...,
["batch_stats": ...]}`` tree (leaves as numpy arrays; packed and unpacked
models share the tree) of either family and returns the port's state
dict, whose keys are the torch reference's.

- flax conv kernel (kD, kH, kW, I, O) -> ``Conv3d`` (O, I, kD, kH, kW);
- flax transposed kernel (kD, kH, kW, I, O) -> ``ConvTranspose3d``
  (I, O, kD, kH, kW) with the spatial flip undone (torch's transposed conv
  is the adjoint of its correlation; flax applies the kernel unflipped);
- GroupNorm and BatchNorm ``scale``/``bias`` -> ``weight``/``bias``;
- ``batch_stats`` ``mean``/``var`` -> ``running_mean``/``running_var``, and
  a ``num_batches_tracked`` of 0 (flax keeps no count);
- a ``DoubleConv`` block's ``conv1``/``conv2`` -> ``SingleConv1``/``SingleConv2``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

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


def _emit_block(out: Dict[str, np.ndarray], prefix: str, block: Mapping,
                stats: Optional[Mapping], double: bool) -> None:
    for name, layers in sorted(block.items()):
        if not name.startswith("conv"):
            raise ValueError(f"unexpected block entry {prefix}{name!r}")
        tname = f"SingleConv{name[len('conv'):]}" if double else name
        for layer, leaves in layers.items():
            key = f"{prefix}{tname}.{layer}"
            if layer == "conv":
                out[f"{key}.weight"] = _conv(leaves["kernel"])
                if "bias" in leaves:
                    out[f"{key}.bias"] = _vec(leaves["bias"])
            elif layer in ("groupnorm", "batchnorm"):
                out[f"{key}.weight"] = _vec(leaves["scale"])
                out[f"{key}.bias"] = _vec(leaves["bias"])
                if layer == "batchnorm":
                    st = (stats or {}).get(name, {}).get("batchnorm")
                    if st is None:
                        raise ValueError(f"{key}: BatchNorm parameters without running "
                                         "statistics (no batch_stats collection)")
                    out[f"{key}.running_mean"] = _vec(st["mean"])
                    out[f"{key}.running_var"] = _vec(st["var"])
                    out[f"{key}.num_batches_tracked"] = np.asarray(0, np.int64)
            else:
                raise ValueError(f"unexpected layer {prefix}{name}.{layer!r}")


def state_dict_from_jax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's ``variables`` -> the port's state dict (CPU; fp32,
    the BatchNorm counts int64)."""
    params = variables["params"]
    stats = variables.get("batch_stats") or {}
    double = "conv3" not in params["encoder0"]["block"]
    out: Dict[str, np.ndarray] = {}
    for name in sorted(params):
        node = params[name]
        if name == "final_conv":
            out["final_conv.weight"] = _conv(node["kernel"])
            out["final_conv.bias"] = _vec(node["bias"])
        elif name.startswith(("encoder", "decoder")):
            kind = "encoder" if name.startswith("encoder") else "decoder"
            i = int(name[len(kind):])
            prefix = f"{kind}s.{i}."
            if "upsample" in node:
                out[f"{prefix}upsample.weight"] = _conv_transpose(node["upsample"]["kernel"])
                out[f"{prefix}upsample.bias"] = _vec(node["upsample"]["bias"])
            _emit_block(out, f"{prefix}basic_module.", node["block"],
                        stats.get(name, {}).get("block"), double)
        else:
            raise ValueError(f"unexpected top-level param entry {name!r}")
    return {k: torch.from_numpy(v.copy()) for k, v in out.items()}


def load_jax_params(model: nn.Module, variables: Mapping[str, Any]) -> None:
    """Strict-load the JAX package's parameters (and BatchNorm statistics)
    into ``model`` (any device)."""
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
