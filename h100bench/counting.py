"""Work that a cell's layers must do, computed from shapes alone.

- The H100's peaks (NVIDIA's data sheet, SXM part, dense): 989 TFLOP/s in
  bf16, 3.35 TB/s of HBM.
- Logical FLOPs, as the standard MFU convention counts them: MACs x 2 of
  every convolution and matrix product of one sample's forward, which the
  cell's family gives (``families/<model>.py``: ``forward_flops``, and
  ``conv_flops``, the convolutions' share); a train step is 3 x the
  forward.  Normalisation, pooling, the loss and the optimizer are left out.
- The bytes of the GroupNorm layer's own function (K1), over the norm
  layers the family lists (``norm_layers``): forward, x (and the residual,
  where the block adds it) read and y written; backward, x, dy (and the
  residual) read and dx (and the residual's gradient) written, once each,
  in the compute dtype.  Whatever kernels implement the layer, they cannot
  move less.
- The bytes of the tile gather (K2): each tile read once from the f16
  volume and written once in the compute dtype.
"""

from __future__ import annotations

from typing import Iterable, Sequence, Tuple

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

# (channels, voxels a sample, adds the residual) of one norm layer
NormLayer = Tuple[int, int, bool]


def conv(spatial: Sequence[int], k: int, c_in: int, c_out: int) -> float:
    """Logical FLOPs of a k^3 convolution producing ``spatial`` output."""
    vox = 1.0
    for s in spatial:
        vox *= s
    return 2.0 * vox * k ** 3 * c_in * c_out


def train_step_flops(forward: float, batch: int) -> float:
    """A train step's FLOPs from one sample's forward FLOPs."""
    return 3.0 * batch * forward


def _dtype_bytes(cfg: dict) -> int:
    return {"bfloat16": 2, "float16": 2, "float32": 4}[cfg["dtype"]]


def k1_forward_bytes(cfg: dict, norms: Iterable[NormLayer], batch: int) -> float:
    e = _dtype_bytes(cfg)
    return float(sum(batch * c * vox * e * (3 if res else 2) for c, vox, res in norms))


def k1_backward_bytes(cfg: dict, norms: Iterable[NormLayer], batch: int) -> float:
    e = _dtype_bytes(cfg)
    return float(sum(batch * c * vox * e * (5 if res else 3) for c, vox, res in norms))


def k2_bytes(cfg: dict, patch: Sequence[int], tiles: int) -> float:
    vox = 1
    for p in patch:
        vox *= p
    return float(tiles * vox * int(cfg["in_channels"]) * (2 + _dtype_bytes(cfg)))


def scaled(work: dict, samples: int) -> dict:
    """A family's work a sample for each of its own kernel groups
    (``group_work``), over ``samples``."""
    return {g: {k: samples * v for k, v in w.items()} for g, w in work.items()}
