"""Analytic logical FLOPs of the U-Net family, for an MFU figure.

The port's copy of ``tpu_mednet/utils/flops.py``: the LOGICAL model flops
(what the math requires), the standard MFU convention: a train step is 3x
the forward's convolution flops (one forward and two conv-like backward
passes); remat's recompute, normalization, pooling, optimizer and loss
flops are left out as negligible.  Counting is independent of the kernels
that run the model (cuDNN's algorithms, the packed TPU layout), so both
packages report the same numbers for the same shapes.

Reference geometry: ResidualUNet3D / UNet3D
(`midasmednet/unet/model.py:11-213`); Swin UNETR v1 (MONAI's
``SwinUNETR``, ``models/swin_unetr.py``), whose count adds its Linear
layers' and window attention's matrix products to the convolutions'.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple


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


def swin_unetr_forward_terms(
    in_channels: int,
    out_channels: int,
    feature_size: int,
    patch: Tuple[int, int, int],
    depths: Sequence[int] = (2, 2, 2, 2),
    num_heads: Sequence[int] = (3, 6, 12, 24),
    window: int = 7,
    patch_size: int = 2,
    mlp_ratio: int = 4,
) -> Dict[str, float]:
    """Logical forward flops of one sample through Swin UNETR v1, by kind:

    - ``conv``: the patch embedding, every 3^3 and 1x1x1 convolution of the
      residual blocks at its output extent, the 2^3 stride-2 transposed
      convolutions at their input extent, the 1x1x1 head;
    - ``linear``: qkv, proj and the MLP's two layers at the stage's own
      tokens, and the patch merging at the merged tokens (2 x tokens x
      C_in x C_out each);
    - ``attention``: QK^T and PV, 4 n^2 d a window and head, over the
      windows of the padded grid (padded tokens attend and are attended).
    """
    fs = feature_size
    vox = [p // patch_size for p in patch]
    n_vox = vox[0] * vox[1] * vox[2]
    conv = _conv_flops(vox, 1, in_channels * patch_size ** 3, fs)
    linear = attention = 0.0
    for i, (depth, heads) in enumerate(zip(depths, num_heads)):
        c = fs * 2 ** i
        ext = [v // 2 ** i for v in vox]
        tokens = ext[0] * ext[1] * ext[2]
        ws = [e if e <= window else window for e in ext]
        n = ws[0] * ws[1] * ws[2]
        windows = 1
        for e, w in zip(ext, ws):
            windows *= -(-e // w)
        per_block = 2.0 * tokens * (3 * c * c + c * c + 2 * mlp_ratio * c * c)
        linear += depth * per_block + 2.0 * (tokens // 8) * 8 * c * 2 * c
        attention += depth * 4.0 * n * n * (c // heads) * windows * heads

    def res(spatial, c_in, c_out):
        f = _conv_flops(spatial, 3, c_in, c_out) + _conv_flops(spatial, 3, c_out, c_out)
        return f + (_conv_flops(spatial, 1, c_in, c_out) if c_in != c_out else 0.0)

    def at(level):
        return [p // 2 ** level for p in patch]

    conv += res(at(0), in_channels, fs) + res(at(1), fs, fs) + res(at(2), 2 * fs, 2 * fs)
    conv += res(at(3), 4 * fs, 4 * fs) + res(at(5), 16 * fs, 16 * fs)
    for level, c_in, c_out in ((4, 16 * fs, 8 * fs), (3, 8 * fs, 4 * fs),
                               (2, 4 * fs, 2 * fs), (1, 2 * fs, fs), (0, fs, fs)):
        conv += _conv_flops(at(level + 1), 2, c_in, c_out) + res(at(level), 2 * c_out, c_out)
    conv += _conv_flops(patch, 1, fs, out_channels)
    return {"conv": conv, "linear": linear, "attention": attention}


def swin_unetr_forward_flops(in_channels: int, out_channels: int, feature_size: int,
                             patch: Tuple[int, int, int], **kw) -> float:
    """Logical forward flops of one sample through Swin UNETR v1: every
    convolution, Linear layer and attention product
    (``swin_unetr_forward_terms``)."""
    return float(sum(swin_unetr_forward_terms(in_channels, out_channels, feature_size,
                                              patch, **kw).values()))
