"""Work that a cell's layers must do, computed from shapes alone.

- The H100's peaks (NVIDIA's data sheet, SXM part, dense): 989 TFLOP/s in
  bf16, 3.35 TB/s of HBM.
- Logical convolution FLOPs of the ResidualUNet3D, as the standard MFU
  convention counts them (a copy of the arithmetic in
  ``tpu_mednet_torch/utils/flops.py``, which the tests hold it to): MACs x 2
  of every 3^3 convolution at its output extent, the stride-2 transposed
  convolution at its input extent, the 1x1x1 head; a train step is 3 x the
  forward.  Normalisation, pooling, the loss and the optimizer are left out.
- The bytes of the GroupNorm layer's own function (K1): forward, x (and the
  residual, where the block adds it) read and y written; backward, x, dy
  (and the residual) read and dx (and the residual's gradient) written,
  once each, in the compute dtype.  Whatever kernels implement the layer,
  they cannot move less.
- The bytes of the tile gather (K2): each tile read once from the f16
  volume and written once in the compute dtype.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

from h100bench.reference.unet import feature_maps

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def _conv(spatial: Sequence[int], k: int, c_in: int, c_out: int) -> float:
    vox = 1.0
    for s in spatial:
        vox *= s
    return 2.0 * vox * k ** 3 * c_in * c_out


def forward_flops(cfg: dict, patch: Sequence[int]) -> float:
    """Logical conv FLOPs of one sample's forward."""
    f = feature_maps(cfg)
    total, c_prev = 0.0, int(cfg["in_channels"])
    for i, c in enumerate(f):
        spatial = [p // 2 ** i for p in patch]
        total += _conv(spatial, 3, c_prev, c) + 2 * _conv(spatial, 3, c, c)
        c_prev = c
    for lvl in range(len(f) - 2, -1, -1):
        spatial = [p // 2 ** lvl for p in patch]
        total += _conv([s // 2 for s in spatial], 3, f[lvl + 1], f[lvl])
        total += 3 * _conv(spatial, 3, f[lvl], f[lvl])
    return total + _conv(patch, 1, f[0], int(cfg["out_channels"]))


def train_step_flops(cfg: dict, patch: Sequence[int], batch: int) -> float:
    return 3.0 * batch * forward_flops(cfg, patch)


def group_norms(cfg: dict, patch: Sequence[int]) -> List[Tuple[int, int, bool]]:
    """(channels, voxels a sample, adds the residual) of every GroupNorm."""
    out = []
    f = feature_maps(cfg)
    for i, c in enumerate(f):
        vox = 1
        for p in patch:
            vox *= p // 2 ** i
        out += [(c, vox, False), (c, vox, False), (c, vox, True)]
        if i < len(f) - 1:  # the decoder stage at this level
            out += [(c, vox, False), (c, vox, False), (c, vox, True)]
    return out


def _dtype_bytes(cfg: dict) -> int:
    return {"bfloat16": 2, "float16": 2, "float32": 4}[cfg["dtype"]]


def k1_forward_bytes(cfg: dict, patch: Sequence[int], batch: int) -> float:
    e = _dtype_bytes(cfg)
    return float(sum(batch * c * vox * e * (3 if res else 2)
                     for c, vox, res in group_norms(cfg, patch)))


def k1_backward_bytes(cfg: dict, patch: Sequence[int], batch: int) -> float:
    e = _dtype_bytes(cfg)
    return float(sum(batch * c * vox * e * (5 if res else 3)
                     for c, vox, res in group_norms(cfg, patch)))


def k2_bytes(cfg: dict, patch: Sequence[int], tiles: int) -> float:
    vox = 1
    for p in patch:
        vox *= p
    return float(tiles * vox * int(cfg["in_channels"]) * (2 + _dtype_bytes(cfg)))
