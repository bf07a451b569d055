"""Analytic logical FLOPs of the U-Net family, for an MFU figure.

The port's copy of ``tpu_mednet/utils/flops.py``: the LOGICAL model flops
(what the math requires), the standard MFU convention: a train step is 3x
the forward's convolution flops (one forward and two conv-like backward
passes); remat's recompute, normalization, pooling, optimizer and loss
flops are left out as negligible.  Counting is independent of the kernels
that run the model (cuDNN's algorithms, the packed TPU layout), so both
packages report the same numbers for the same shapes.

Reference geometry: ResidualUNet3D / UNet3D
(`midasmednet/unet/model.py:11-213`).
"""

from __future__ import annotations

from typing import Sequence, Tuple


def _conv_flops(spatial: Sequence[int], k: int, c_in: int, c_out: int) -> float:
    """MAC-counted (x2) flops of a SAME conv producing ``spatial`` output."""
    vox = 1.0
    for s in spatial:
        vox *= s
    return 2.0 * vox * (k ** 3) * c_in * c_out


def unet_forward_flops(
    in_channels: int,
    out_channels: int,
    feature_maps: Sequence[int],
    patch: Tuple[int, int, int],
    block: str = "residual",
    kernel_size: int = 3,
) -> float:
    """Logical forward conv flops of one sample through the U-Net.

    - 'residual' (ExtResNetBlock): 3 convs per stage; decoder joins via a
      stride-2 transposed conv (flops counted at its INPUT spatial extent).
    - 'double' (DoubleConv): 2 convs per stage with the encoder
      ``max(out//2, in)`` mid width; decoder joins via resize + concat
      (no conv flops in the join itself).
    """
    k = kernel_size
    f = list(feature_maps)
    n_levels = len(f)
    total = 0.0

    # encoder
    c_prev = in_channels
    for i, c in enumerate(f):
        spatial = [p // (2 ** i) for p in patch]
        if block == "residual":
            total += _conv_flops(spatial, k, c_prev, c)
            total += 2 * _conv_flops(spatial, k, c, c)
        else:
            mid = max(c // 2, c_prev)
            total += _conv_flops(spatial, k, c_prev, mid)
            total += _conv_flops(spatial, k, mid, c)
        c_prev = c

    # decoder: stages output at levels n-2 .. 0
    for lvl in range(n_levels - 2, -1, -1):
        c_deep, c_out_lvl = f[lvl + 1], f[lvl]
        spatial = [p // (2 ** lvl) for p in patch]
        in_spatial = [s // 2 for s in spatial]
        if block == "residual":
            # transposed conv (k^3 taps per INPUT voxel) + 3-conv block
            total += _conv_flops(in_spatial, k, c_deep, c_out_lvl)
            total += 3 * _conv_flops(spatial, k, c_out_lvl, c_out_lvl)
        else:
            # concat join: block conv1 sees c_deep + c_out_lvl channels
            total += _conv_flops(spatial, k, c_deep + c_out_lvl, c_out_lvl)
            total += _conv_flops(spatial, k, c_out_lvl, c_out_lvl)

    # 1x1x1 head
    total += _conv_flops(patch, 1, f[0], out_channels)
    return total


def unet_train_step_flops(
    in_channels: int,
    out_channels: int,
    feature_maps: Sequence[int],
    patch: Tuple[int, int, int],
    batch: int,
    block: str = "residual",
) -> float:
    """Logical train-step flops: 3x forward (fwd + dgrad + wgrad)."""
    return 3.0 * batch * unet_forward_flops(
        in_channels, out_channels, feature_maps, patch, block=block
    )
