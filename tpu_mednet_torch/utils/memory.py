"""Device-memory estimates of the on-device stitches, and the guard that
spills a volume too large for the card to the host stitch.

The inference half of ``tpu_mednet/utils/memory.py``, refit for the port
on the card: an on-device stitch holds the whole padded volume and its
result (or, for the Gaussian stitch, two fp32 accumulators) on the card,
so a large enough volume would die as a CUDA out-of-memory error halfway
through.  ``check_stitch_budget`` estimates each volume's footprint before
anything is uploaded and then fails with the numbers (``error``), logs and
sends the volume to the host stitch (``warn``, the predict CLI's default),
or lets it through (``off``).

The model is phase-max, as in JAX: the peak is the larger of the scan
phase (input volume + padded volume + result or accumulators + one
batch's forward working set) and the finalize phase (padded volume +
result or accumulators + the cropped output).  The volume terms are exact
sizes.  The forward working set is the batch's input tiles, its fp32
logits and class probabilities, the encoder skips and
``INFER_WORK_UNITS`` full-resolution units; the Gaussian stitch adds
``GAUSSIAN_WORK_UNITS`` and mirror TTA ``TTA_WORK_UNITS`` fp32 patch
batches at the model's output width.

The constants are fit to the caching allocator's peak
(``torch.cuda.max_memory_reserved`` after ``empty_cache`` and
``reset_peak_memory_stats``; it holds 0.3-1.1 GiB more than the peak of
live tensors) of one volume on each stitch, measured by
``chip_memory_fit.py`` on an NVIDIA H100 80GB HBM3, 700.00 W: f_maps 32,
bf16, batch 8 of 96^3 tiles, overlap 16.  Peak reserved GiB (estimate /
measured), n_tta 1 at 192^3, 320^3, 512^3, then n_tta 8 at the same:

    in 1, 2 classes, device    3.994 (1.013) 4.090 (1.023) 3.652 (1.287)
                               3.994 (1.079) 4.090 (1.087) 4.496 (1.104)
    in 1, 2 classes, gaussian  4.107 (1.064) 4.580 (1.057) 5.877 (1.116)
                               4.107 (1.128) 4.580 (1.114) 6.299 (1.083)
    in 4, 2 classes, device    3.820 (1.096) 4.338 (1.072) 5.881 (1.086)
                               4.242 (1.049) 4.338 (1.133) 5.881 (1.131)
    in 4, 2 classes, gaussian  4.326 (1.043) 4.664 (1.138) 7.082 (1.165)
                               4.326 (1.104) 5.086 (1.095) 7.082 (1.202)
    in 4, 4 classes, device    3.820 (1.123) 4.338 (1.096) 5.459 (1.190)
                               4.242 (1.136) 4.338 (1.218) 5.881 (1.194)
    in 4, 4 classes, gaussian  4.410 (1.114) 5.410 (1.099) 8.281 (1.179)
                               4.410 (1.234) 5.410 (1.197) 8.703 (1.183)

The double family (``UNet3D(1, 3)`` at its defaults, f_maps 64, bf16, the
same geometry; ``chip_memory_fit.py --double-only``, alone in a process)
peaks at 11.729-12.477 GiB reserved in order ``gcr`` and 8.553-9.301 GiB
in ``cbr`` over one volume of 192^3 and 320^3 (n_tta 1) and 192^3 (n_tta
8) on both stitches: the 192-channel concatenation at full resolution, and
for ``gcr`` its normalized copy, which the residual family's working set
does not hold.  ``JOIN_INFER_UNITS`` and ``NORM_FIRST_UNITS`` are the
centre of the window that keeps those twelve points in [1, 1.3] (1.111 to
1.190, 11 % from each end).

Swin UNETR (``models/swin_unetr.py``) gives its own forward working set
(``SwinUNETRConfig.infer_peak_bytes``: ``swin_unetr_infer_peak_bytes``
with its shifted blocks' masks), which the guard takes in place of the
U-Net's.  ``chip_memory_fit.py --swin-only`` on the same card, BTCV's
widths (feature_size 48, 1 -> 14, bf16), 96^3 tiles, overlap 16; peak
reserved GiB (estimate / measured) on the device and the Gaussian stitch:
192^3 5.764 (1.134), 7.660 (1.126); 320^3 5.908 (1.129), 9.613 (1.097);
192^3 n_tta 8 7.029 (1.192), 8.926 (1.173), each at batch 8; 192^3 at
batch 2 1.770 (1.177), 2.717 (1.130) and at batch 1 1.141 (1.176), 1.918
(1.118), each ratio at the constant below (the run, at 8.0, read 1.165 to
1.295).  ``SWIN_INFER_WORK_UNITS`` is the centre of the window that keeps
those ten points in [1, 1.3] ([5.65, 8.06]).  Read as a residual U-Net's
(widths 48, 48, 96, 192, 384, 768), the same points estimated 0.936 to
1.195: under the peak at batch 1, where the masks weigh most.

Two 192^3 volumes in one call peak as one does (the pipeline's pending
uint8 result is small).  The constants are the centre of the window that
keeps every point's ratio in [1, 1.3] (margin 1.3 % each side: the
flagship's 512^3 device point, whose allocator cache stayed small, bounds
it from above; the flagship's 192^3 device point from below).  At the
guard's edge, the largest 4-input, 4-class cube it admits on the Gaussian
stitch under the default budget (1264^3: estimate 78.506 of 78.561 GiB)
fit, with a peak of 63.002 GiB reserved (ratio 1.246).

The training half, ``unet_train_peak_bytes``, keeps the JAX package's
structure (stored and recomputed stages, fp32 GroupNorm units of stored
full-resolution stages, the logits, the parameters) and adds one term, the
full-resolution units the backward holds beside the stored activations:
its gradients and, under remat, the recomputed stage's activations (the
JAX model folds that into its overhead; with ``TRAIN_WORK_UNITS`` 0 and
JAX's two constants it is JAX's estimate).  Fit to
``torch.cuda.max_memory_reserved`` of three train steps (Adam, mirror
flips, bf16) by ``chip_memory_fit.py`` on the same card; GiB reserved
(estimate / measured) at remat 0, 1 and all, after the inference section
in the same process:

    f_maps 32, 1 -> 2, batch 8 of 96^3      9.777 (1.218)  7.631 (1.095)  5.854 (1.227)
                       batch 16             19.268 (1.213) 15.020 (1.082) 11.799 (1.178)
                       batch 32             38.301 (1.208) 29.756 (1.077) 23.004 (1.188)
    seg_brats_bf16, batch 2 of 128^3        6.043 (1.217)  4.621 (1.135)
    landmarks (f_maps 64), batch 4 of 96^3  11.229 (1.186) 9.082 (1.075)

UNet3D (``block="double"``: f_maps 64, 4 levels, order ``gcr``, 1 -> 3,
16,318,821 parameters), batch 4, 8 and 16 of 96^3 alone in a process
(``chip_memory_fit.py --double-only``), GiB reserved (estimate / measured)
at remat 0 and 1:

    batch 4     8.932 (1.159)   8.508 (1.160)
    batch 8    17.721 (1.156)  16.982 (1.150)
    batch 16   35.334 (1.154)  34.068 (1.140)

Remat 1 saves 4 % there (the peak is in the full-resolution decoder's
backward, where the 192-channel concatenation, the resized 128-channel
feature and their gradients are live whether or not the stage is
recomputed), so JAX's stored-activation factor overstates remat 0:
``DOUBLE_OVERHEAD`` and ``JOIN_UNITS`` are the centre of the window that
keeps those six points in [1, 1.3], 14 % from each end.

The allocator's reserved peak moves with what ran before in the process
(alone, the batch-32 points read 38.309, 28.439 and 23.795 GiB).  The
port's K1 keeps no fp32 buffers across the backward, so ``GN_F32_UNITS``
is 0; ``TRAIN_OVERHEAD`` and ``TRAIN_WORK_UNITS`` are the centre of the
window that kept the first measured points and ``chip_smoke.py``'s
batch-32 steps (38.340, 29.807 and 22.947 GiB at remat 0, 1 and all) in
[1, 1.3], 7.5 % from each end.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

logger = logging.getLogger(__name__)

GiB = float(1 << 30)

# full-resolution (level-0) activation units that one inference forward
# holds in the caching allocator beyond the encoder skips: the block's
# conv and GroupNorm outputs, the residual, the transposed conv's output,
# cuDNN's workspace and the allocator's cached blocks (fit on the card,
# module docstring)
INFER_WORK_UNITS = 7.56

# full-resolution concatenations (f[0] + f[1] channels) that the double
# family's forward holds beyond the residual family's working set, and the
# more where the order normalizes before it convolves (fit on the card,
# module docstring)
JOIN_INFER_UNITS = 0.69
NORM_FIRST_UNITS = 1.39

# fp32 patch batches at the model's output width that the Gaussian stitch
# holds beside the forward: the activations, their weighted copy and the
# allocator's cached blocks around them (fit on the card, module docstring)
GAUSSIAN_WORK_UNITS = 4.0

# the training half (unet_train_peak_bytes; fit on the card, module
# docstring): the factor on the stored activations, fp32 GroupNorm units
# per stored full-resolution conv, and full-resolution units the backward
# holds beside the stored activations
TRAIN_OVERHEAD = 1.25
GN_F32_UNITS = 0.0
TRAIN_WORK_UNITS = 13.5
# the double family (fit on the card, module docstring): the factor on its
# stored activations (TRAIN_OVERHEAD's place) and on its concat-join
# temporaries (the resized deeper feature and the concatenation at each
# decoder's output level), which JAX counts once outside its factor.  Its
# peak falls in the full-resolution decoder's backward, where the join's
# temporaries and their gradients are live, not at the end of the forward
DOUBLE_OVERHEAD = 0.24
JOIN_UNITS = 1.26

# full-resolution units (feature_size channels) that one Swin UNETR
# inference forward holds beyond the features its decoder joins and its
# shifted blocks' masks: the last up block's transposed conv, concatenation
# and residual block, the head and the allocator's cached blocks (fit on
# the card, module docstring)
SWIN_INFER_WORK_UNITS = 6.86

# fp32 patch batches at the model's output width that mirror TTA keeps
# live beside the forward: the running sum, a flipped activation and its
# flip back (fit on the card, module docstring)
TTA_WORK_UNITS = 5.0


def param_bytes(model: torch.nn.Module) -> int:
    """Bytes of a module's parameters and buffers."""
    return sum(t.numel() * t.element_size()
               for t in (*model.parameters(), *model.buffers()))


def _unit_bytes(batch: int, patch: Sequence[int], level: int, channels: int,
                dtype_bytes: int) -> float:
    """Bytes of one full activation at encoder/decoder level ``level``."""
    vox = 1.0
    for p in patch:
        vox *= max(int(p) >> level, 1)
    return float(batch) * vox * channels * dtype_bytes


def norm_before_conv(order: str) -> bool:
    """Whether an order string normalizes before it convolves (``gcr``):
    the conv's input is then materialized a second time, normalized."""
    norms = [order.index(ch) for ch in "gb" if ch in order]
    return bool(norms) and min(norms) < order.index("c")


def unet_infer_peak_bytes(batch: int, patch: Sequence[int],
                          feature_maps: Sequence[int], dtype_bytes: int = 2,
                          block: str = "residual", layer_order: str = "cge") -> int:
    """Working set of one inference forward: the encoder skip features stay
    live until their decoder joins, plus ``INFER_WORK_UNITS`` units at the
    widest level; the double family adds ``JOIN_INFER_UNITS``
    concatenations at full resolution (``f[0] + f[1]`` channels), and
    ``NORM_FIRST_UNITS`` more where the order normalizes before it
    convolves (``norm_before_conv``: the concatenation normalized)."""
    f = list(feature_maps)
    skips = sum(_unit_bytes(batch, patch, lvl, c, dtype_bytes)
                for lvl, c in enumerate(f[:-1]))
    work = INFER_WORK_UNITS * _unit_bytes(batch, patch, 0, f[0], dtype_bytes)
    if block == "double":
        joins = JOIN_INFER_UNITS + (NORM_FIRST_UNITS if norm_before_conv(layer_order) else 0)
        work += joins * _unit_bytes(batch, patch, 0, f[0] + f[1], dtype_bytes)
    return int(skips + work)


def swin_unetr_infer_peak_bytes(batch: int, patch: Sequence[int], feature_size: int,
                                fixed_bytes: int = 0, dtype_bytes: int = 2) -> int:
    """Working set of one Swin UNETR inference forward
    (``models/swin_unetr.py``): the features held to the end of the
    forward (enc0 at full resolution; at levels 1-3 a hidden state and its
    encoder block's output, ``feature_size`` wide at level 1 and doubling a
    level; hs3 at level 4, hs4 at level 5), ``SWIN_INFER_WORK_UNITS``
    full-resolution units, and ``fixed_bytes``, what the model holds
    whatever the batch (its shifted blocks' masks,
    ``SwinUNETRConfig.infer_peak_bytes``)."""
    fs = feature_size
    held = _unit_bytes(batch, patch, 0, fs, dtype_bytes)
    held += sum(2 * _unit_bytes(batch, patch, lvl, fs << (lvl - 1), dtype_bytes)
                for lvl in (1, 2, 3))
    held += _unit_bytes(batch, patch, 4, 8 * fs, dtype_bytes)
    held += _unit_bytes(batch, patch, 5, 16 * fs, dtype_bytes)
    work = SWIN_INFER_WORK_UNITS * _unit_bytes(batch, patch, 0, fs, dtype_bytes)
    return int(held + work + fixed_bytes)


def unet_train_peak_bytes(batch: int, patch: Sequence[int], feature_maps: Sequence[int],
                          in_channels: int = 1, out_channels: int = 3, n_params: int = 0,
                          dtype_bytes: int = 2, block: str = "residual",
                          remat: Union[bool, int] = 1) -> int:
    """Peak device bytes of one train step (forward, backward, Adam) of the
    U-Net, ``tpu_mednet/utils/memory.py:124-196``'s structure.

    Stored for the backward: every stage's input; a stage that is not
    recomputed (``remat``, ``models/unet.py``) also its conv outputs (3 per
    residual stage, 2 per ``double`` stage) and, at full resolution,
    ``GN_F32_UNITS`` fp32 units per conv; a recomputed decoder stage its
    previous stage's output; for ``double``, every encoder skip until its
    decoder's concatenation takes it.  Plus the fp32 logits and the loss's
    copy of them.  Those activation bytes are scaled by ``TRAIN_OVERHEAD``
    (``DOUBLE_OVERHEAD`` for ``double``); ``TRAIN_WORK_UNITS``
    full-resolution units cover what the backward holds beside them (the
    gradients, and the recomputed stage); for ``double``, each decoder's
    join temporaries at its output level (the resized deeper feature and
    the concatenation), ``JOIN_UNITS`` times, stand outside the factor;
    parameters take ``12 + dtype_bytes`` bytes each.  With JAX's constants
    (both factors ``XLA_OVERHEAD``, ``GN_F32_UNITS`` 2, ``JOIN_UNITS`` 1,
    no work units) it is JAX's estimate.
    """
    if block not in ("residual", "double"):
        raise ValueError(f"block must be 'residual' or 'double', got {block!r}")
    f = list(feature_maps)
    n_levels = len(f)
    convs = 3 if block == "residual" else 2
    remat_k = n_levels if remat is True else int(remat)
    act = 0.0
    join_raw = 0.0
    # encoder stage i consumes the level-(i-1) output and produces level i
    for i, c in enumerate(f):
        act += _unit_bytes(batch, patch, max(i - 1, 0), f[i - 1], dtype_bytes) \
            if i else _unit_bytes(batch, patch, 0, in_channels, dtype_bytes)
        if block == "double" and i < n_levels - 1:
            act += _unit_bytes(batch, patch, i, c, dtype_bytes)
        if i >= remat_k:
            act += convs * _unit_bytes(batch, patch, i, c, dtype_bytes)
            if i == 0:
                act += GN_F32_UNITS * convs * _unit_bytes(batch, patch, 0, c, 4)
    # decoder stage j outputs at level n_levels - 2 - j
    for j in range(n_levels - 1):
        out_lvl = n_levels - 2 - j
        if block == "double":
            join_raw += _unit_bytes(batch, patch, out_lvl, f[out_lvl] + 2 * f[out_lvl + 1],
                                    dtype_bytes)
        if out_lvl >= remat_k:
            act += (convs + 1) * _unit_bytes(batch, patch, out_lvl, f[out_lvl], dtype_bytes)
            if out_lvl == 0:
                act += GN_F32_UNITS * convs * _unit_bytes(batch, patch, 0, f[0], 4)
        else:
            act += _unit_bytes(batch, patch, out_lvl + 1, f[out_lvl + 1], dtype_bytes)
    act += 2 * _unit_bytes(batch, patch, 0, out_channels, 4)
    work = TRAIN_WORK_UNITS * _unit_bytes(batch, patch, 0, f[0], dtype_bytes)
    params = n_params * (12 + dtype_bytes)
    overhead = TRAIN_OVERHEAD if block == "residual" else DOUBLE_OVERHEAD
    return int(act * overhead + work + JOIN_UNITS * join_raw + params)


def _padded_extent(img_size, patch_size, overlap) -> np.ndarray:
    """Padded-volume extent of the grid geometry (``inference/common.grid_corners``)."""
    img = np.asarray(img_size, dtype=np.int64)
    patch = np.asarray(patch_size, dtype=np.int64)
    ov = np.asarray(overlap, dtype=np.int64)
    stride = patch - 2 * ov
    if np.any(stride <= 0):
        raise ValueError("patch_overlap too large for patch_size")
    return img + 2 * ov + (-img) % stride


def device_stitch_bytes(
    img_size: Sequence[int],
    patch_size: Sequence[int],
    patch_overlap: Sequence[int],
    batch_size: int,
    in_channels: int,
    out_channels: int,
    feature_maps: Sequence[int] = (),
    stitch: str = "device",
    dtype_bytes: int = 2,
    params_bytes: int = 0,
    n_tta: int = 1,
    acc_channels: Optional[int] = None,
    block: str = "residual",
    layer_order: str = "cge",
    net_bytes: Optional[int] = None,
) -> Tuple[int, Dict[str, int]]:
    """Estimated device bytes of one volume on an on-device stitch.

    Returns ``(total_bytes, breakdown)``:

    - ``stitch='device'`` (``inference/device_sliding.py``): f16 input
      volume + f16 padded copy + uint8 result over the padded domain + the
      cropped copy;
    - ``stitch='gaussian'`` (``inference/weighted.py``): an fp32 activation
      accumulator ``acc_channels`` wide (the model's out_channels, wider
      than the uint8 result's ``out_channels`` for multi-class tasks) and an
      fp32 weight accumulator instead of the padded result.

    ``acc_channels`` (default ``out_channels``) also sizes the TTA term,
    whose running sum is the model's output width.  The model's forward
    working set is ``net_bytes`` where the model gives its own (Swin
    UNETR's ``config.infer_peak_bytes``), else the U-Net's of
    ``feature_maps``, ``block`` and ``layer_order``
    (``unet_infer_peak_bytes``).
    """
    if acc_channels is None:
        acc_channels = out_channels
    img_vox = float(np.prod(np.asarray(img_size, dtype=np.float64)))
    padded_vox = float(np.prod(
        _padded_extent(img_size, patch_size, patch_overlap).astype(np.float64)))
    breakdown: Dict[str, int] = {
        "input_volume_f16": int(img_vox * in_channels * 2),
        "padded_volume_f16": int(padded_vox * in_channels * 2),
        "params": int(params_bytes),
    }
    # the batch's input tiles, fp32 logits and probabilities, then the net
    patch_vox = float(np.prod(np.asarray(patch_size, dtype=np.float64)))
    acc_unit = batch_size * patch_vox * acc_channels * 4
    fwd = batch_size * patch_vox * in_channels * dtype_bytes + 2 * acc_unit
    fwd += net_bytes if net_bytes is not None else unet_infer_peak_bytes(
        batch_size, patch_size, feature_maps, dtype_bytes, block, layer_order)
    if stitch == "gaussian":
        fwd += GAUSSIAN_WORK_UNITS * acc_unit
    if n_tta > 1:
        fwd += TTA_WORK_UNITS * acc_unit
    breakdown["forward_working_set"] = int(fwd)
    if stitch == "gaussian":
        breakdown["accumulator_f32"] = int(padded_vox * acc_channels * 4)
        breakdown["weight_accumulator_f32"] = int(padded_vox * 4)
        breakdown["result_u8"] = int(img_vox * out_channels)
        resident = (breakdown["padded_volume_f16"] + breakdown["accumulator_f32"]
                    + breakdown["weight_accumulator_f32"])
        final = resident + breakdown["result_u8"]
    elif stitch == "device":
        breakdown["result_u8"] = int(padded_vox * out_channels)
        breakdown["crop_copy_u8"] = int(img_vox * out_channels)
        resident = breakdown["padded_volume_f16"] + breakdown["result_u8"]
        final = resident + breakdown["crop_copy_u8"]
    else:
        raise ValueError(f"stitch must be device or gaussian, got {stitch!r}")
    scan = resident + breakdown["input_volume_f16"] + breakdown["forward_working_set"]
    breakdown["peak_phase_scan"] = int(scan)
    breakdown["peak_phase_final"] = int(final)
    return int(params_bytes + max(scan, final)), breakdown


def hbm_budget_bytes(device=None) -> int:
    """Device-memory budget: ``$TPU_MEDNET_HBM_GB`` (GiB) if set, else what
    this process's caching allocator can reach on the card: the card's
    free memory (``torch.cuda.mem_get_info``) plus what the allocator
    already reserves.  That leaves out the CUDA context, memory libraries
    take outside the allocator and other processes' memory, as JAX's
    allocator limit does; the estimate is fit to the allocator's reserved
    peak.  For a CPU device, the host's physical memory."""
    env = os.environ.get("TPU_MEDNET_HBM_GB")
    if env:
        return int(float(env) * GiB)
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        return int(torch.cuda.mem_get_info(dev)[0] + torch.cuda.memory_reserved(dev))
    return int(os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES"))


class HBMBudgetError(RuntimeError):
    """An on-device stitch request that cannot fit the card's memory."""


def check_stitch_budget(
    key: str,
    img_size: Sequence[int],
    patch_size: Sequence[int],
    patch_overlap: Sequence[int],
    batch_size: int,
    in_channels: int,
    out_channels: int,
    feature_maps: Sequence[int] = (),
    stitch: str = "device",
    dtype_bytes: int = 2,
    params_bytes: int = 0,
    n_tta: int = 1,
    budget_bytes: Optional[int] = None,
    guard: str = "error",
    acc_channels: Optional[int] = None,
    device=None,
    block: str = "residual",
    layer_order: str = "cge",
    net_bytes: Optional[int] = None,
) -> bool:
    """True when the volume fits the on-device stitch.

    ``guard``: ``error`` raises :class:`HBMBudgetError`; ``warn`` logs and
    returns False (the caller stitches the volume on the host); ``off``
    skips the check.  ``budget_bytes`` defaults to ``hbm_budget_bytes(device)``.
    """
    if guard == "off":
        return True
    if guard not in ("error", "warn"):
        raise ValueError(f"hbm_guard must be error|warn|off, got {guard!r}")
    budget = hbm_budget_bytes(device) if budget_bytes is None else int(budget_bytes)
    total, breakdown = device_stitch_bytes(
        img_size, patch_size, patch_overlap, batch_size, in_channels, out_channels,
        feature_maps, stitch=stitch, dtype_bytes=dtype_bytes, params_bytes=params_bytes,
        n_tta=n_tta, acc_channels=acc_channels, block=block, layer_order=layer_order,
        net_bytes=net_bytes)
    if total <= budget:
        return True
    detail = ", ".join(f"{k}={v / GiB:.2f}G" for k, v in breakdown.items())
    msg = (f"volume {key!r} {tuple(int(v) for v in img_size)} needs an estimated "
           f"{total / GiB:.2f}G of device memory on the '{stitch}' stitch path (budget "
           f"{budget / GiB:.2f}G): {detail}. Use prediction.stitch: crop (host "
           f"stitching), a smaller batch_size, or set hbm_guard: off to force the attempt.")
    if guard == "warn":
        logger.warning("%s Falling back to host stitching for this volume.", msg)
        return False
    raise HBMBudgetError(msg)
