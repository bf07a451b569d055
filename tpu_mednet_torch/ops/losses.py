"""Segmentation losses and metrics on channels-first logits.

Counterpart of ``tpu_mednet/ops/losses.py`` (reference
``midasmednet/unet/loss.py:10-142``) for the segmentation task:

- ``compute_per_channel_dice`` / ``dice_metric`` (loss.py:24-55)
- ``expand_as_one_hot``                           (loss.py:58-88)
- ``dice_loss``                                   (loss.py:91-130)
- ``ce_loss``                                     (loss.py:135-142; the
  reference's Softmax before CrossEntropyLoss is reproducible with
  ``double_softmax=True``, off by default as in the JAX package)

Conventions: ``logits``/``probs`` are (N, C, X, Y, Z); integer ``labels``
are (N, X, Y, Z); a one-hot ``target`` is (N, C, X, Y, Z).  Every reduction
is computed in fp32.  The weighted/pixelwise CE, BCE and landmark losses
are not ported yet.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F

EPSILON = 1e-5
Weight = Optional[Union[torch.Tensor, Sequence[float]]]


def flatten_channels(x: torch.Tensor) -> torch.Tensor:
    """(N, C, *spatial) -> (C, N * prod(spatial)) (reference loss.py:10-21)."""
    return x.transpose(0, 1).reshape(x.shape[1], -1)


def expand_as_one_hot(labels: torch.Tensor, num_classes: int,
                      ignore_index: Optional[int] = None) -> torch.Tensor:
    """(N, X, Y, Z) int labels -> (N, C, X, Y, Z) fp32 one-hot.

    With ``ignore_index``, voxels carrying that label get an all-
    ``ignore_index`` row, so later masking recognises them (loss.py:58-88).
    """
    labels = labels.long()
    mask = None if ignore_index is None else labels == ignore_index
    safe = labels if mask is None else torch.where(mask, 0, labels)
    onehot = F.one_hot(safe, num_classes).movedim(-1, 1).float()
    if mask is not None:
        onehot = torch.where(mask.unsqueeze(1), float(ignore_index), onehot)
    return onehot


def _class_weight(weight: Weight, num_classes: int, device) -> Optional[torch.Tensor]:
    if weight is None:
        return None
    w = torch.as_tensor(weight, dtype=torch.float32, device=device)
    if w.shape[-1] != num_classes:
        # e.g. the reference's 2-class default loss weight against a
        # 3-class head: fail with the cause, not a broadcast error
        raise ValueError(
            f"per-class weight has {w.shape[-1]} entries but the loss sees "
            f"{num_classes} classes (check --loss_weight / --loss_class_weight "
            "against out_channels)")
    return w


def compute_per_channel_dice(probs: torch.Tensor, target: torch.Tensor,
                             epsilon: float = EPSILON,
                             ignore_index: Optional[int] = None,
                             weight: Weight = None) -> torch.Tensor:
    """Per-channel soft Dice with an epsilon-clamped denominator
    (loss.py:24-48): optional ignore mask, optional per-channel weight on
    the intersection."""
    if probs.shape != target.shape:
        raise ValueError(f"shape mismatch: {tuple(probs.shape)} vs {tuple(target.shape)}")
    w = _class_weight(weight, probs.shape[1], probs.device)
    probs = probs.float()
    target = target.float()
    if ignore_index is not None:
        mask = (target != ignore_index).float()
        probs = probs * mask
        target = target * mask
    p = flatten_channels(probs)
    t = flatten_channels(target)
    intersect = (p * t).sum(-1)
    if w is not None:
        intersect = w * intersect
    return 2.0 * intersect / (p + t).sum(-1).clamp_min(epsilon)


def dice_metric(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """softmax -> one-hot -> per-channel dice (loss.py:51-55)."""
    probs = torch.softmax(logits.float(), dim=1)
    return compute_per_channel_dice(probs, expand_as_one_hot(labels, logits.shape[1]))


def dice_loss(logits: torch.Tensor, labels: torch.Tensor, epsilon: float = EPSILON,
              weight: Weight = None, ignore_index: Optional[int] = None) -> torch.Tensor:
    """mean(1 - per-channel dice) of the softmax (reference ``DiceLoss``,
    loss.py:91-130); ``labels`` are integer class maps (N, X, Y, Z)."""
    probs = torch.softmax(logits.float(), dim=1)
    target = expand_as_one_hot(labels, logits.shape[1])
    per_channel = compute_per_channel_dice(probs, target, epsilon=epsilon,
                                           ignore_index=ignore_index, weight=weight)
    return (1.0 - per_channel).mean()


def ce_loss(logits: torch.Tensor, labels: torch.Tensor, weight: Weight = None,
            ignore_index: Optional[int] = None,
            double_softmax: bool = False) -> torch.Tensor:
    """Multi-class cross-entropy over voxel logits (loss.py:135-142).

    ``weight`` rescales each class's contribution, and the mean is taken
    over the total weight of the contributing voxels, as torch's weighted
    CE does; voxels labelled ``ignore_index`` contribute nothing.
    """
    w = _class_weight(weight, logits.shape[1], logits.device)
    logits = logits.float()
    if double_softmax:
        logits = torch.softmax(logits, dim=1)
    labels = labels.long()
    logp = torch.log_softmax(logits, dim=1)
    valid = (torch.ones_like(labels, dtype=torch.bool) if ignore_index is None
             else labels != ignore_index)
    safe = torch.where(valid, labels, 0)
    picked = logp.gather(1, safe.unsqueeze(1)).squeeze(1)
    vw = valid.float() if w is None else w[safe] * valid
    return -(vw * picked).sum() / vw.sum().clamp_min(1e-12)
