"""Segmentation losses and metrics on channels-first logits.

Counterpart of ``tpu_mednet/ops/losses.py`` (reference
``midasmednet/unet/loss.py:10-252``):

- ``compute_per_channel_dice`` / ``dice_metric`` (loss.py:24-55)
- ``expand_as_one_hot``                           (loss.py:58-88)
- ``dice_loss``                                   (loss.py:91-130)
- ``ce_loss``                                     (loss.py:135-142; the
  reference's Softmax before CrossEntropyLoss is reproducible with
  ``double_softmax=True``, off by default as in the JAX package)
- ``weighted_ce_loss``                            (loss.py:144-172)
- ``bce_with_masking``                            (loss.py:175-202)
- ``pixelwise_ce_loss``                           (loss.py:204-241)
- ``mse_loss`` / ``l1_loss`` / ``landmark_loss``  (loss.py:243-252)
- ``multitask_landmark_loss``                     (landmarks.py:125-134)

Conventions: ``logits``/``probs`` are (N, C, X, Y, Z); integer ``labels``
are (N, X, Y, Z); a one-hot ``target`` is (N, C, X, Y, Z).  Every reduction
is computed in fp32.  No task calls the weighted, pixelwise and binary
cross-entropies; they complete the reference's loss zoo.

Under data parallelism (``dp``: a ``parallel.mesh.DataMesh`` of more than
one rank, each holding its rows of the global batch, or with a space axis
its X slab of them) every sum over the batch goes through ``dp.all_sum``
before the division, and so does every count, so a loss is the JAX
package's over the global batch; ``None`` is one process.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

EPSILON = 1e-5
Weight = Optional[Union[torch.Tensor, Sequence[float]]]


def _sum(x: torch.Tensor, dp) -> torch.Tensor:
    return x if dp is None else dp.all_sum(x)


def _mean(x: torch.Tensor, dp) -> torch.Tensor:
    """The mean over every element of the global batch."""
    if dp is None:
        return x.mean()
    return dp.all_sum(x.sum()) / dp.count_sum(x.numel())


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


class HeldWeights:
    """A task's loss weights as the fp32 tensors a loss takes, made once per
    device.  A list handed to a loss would be copied from pageable host
    memory at every call, and such a copy waits for everything queued on
    the card; a tensor already on the device passes through
    ``_class_weight`` uncopied.  ``weights`` maps a name to its values (or
    None) and the count they must match, checked when the tensor is made.
    The tensors are made outside inference mode, so one first made in an
    eval step can still be saved for a train step's backward."""

    def __init__(self, **weights: Tuple[Weight, int]):
        self._weights = weights
        self._held: Dict[torch.device, Dict[str, Optional[torch.Tensor]]] = {}

    def on(self, device: torch.device) -> Dict[str, Optional[torch.Tensor]]:
        held = self._held.get(device)
        if held is None:
            with torch.inference_mode(False):
                held = {name: _class_weight(w, n, device) for name, (w, n) in self._weights.items()}
            self._held[device] = held
        return held


def compute_per_channel_dice(probs: torch.Tensor, target: torch.Tensor,
                             epsilon: float = EPSILON,
                             ignore_index: Optional[int] = None,
                             weight: Weight = None, dp=None) -> torch.Tensor:
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
    intersect, denominator = _sum(torch.stack([(p * t).sum(-1), (p + t).sum(-1)]), dp)
    if w is not None:
        intersect = w * intersect
    return 2.0 * intersect / denominator.clamp_min(epsilon)


def dice_metric(logits: torch.Tensor, labels: torch.Tensor, dp=None) -> torch.Tensor:
    """softmax -> one-hot -> per-channel dice (loss.py:51-55)."""
    probs = torch.softmax(logits.float(), dim=1)
    return compute_per_channel_dice(probs, expand_as_one_hot(labels, logits.shape[1]), dp=dp)


def dice_loss(logits: torch.Tensor, labels: torch.Tensor, epsilon: float = EPSILON,
              weight: Weight = None, ignore_index: Optional[int] = None,
              dp=None) -> torch.Tensor:
    """mean(1 - per-channel dice) of the softmax (reference ``DiceLoss``,
    loss.py:91-130); ``labels`` are integer class maps (N, X, Y, Z)."""
    probs = torch.softmax(logits.float(), dim=1)
    target = expand_as_one_hot(labels, logits.shape[1])
    per_channel = compute_per_channel_dice(probs, target, epsilon=epsilon,
                                           ignore_index=ignore_index, weight=weight, dp=dp)
    return (1.0 - per_channel).mean()


def ce_loss(logits: torch.Tensor, labels: torch.Tensor, weight: Weight = None,
            ignore_index: Optional[int] = None,
            double_softmax: bool = False, dp=None) -> torch.Tensor:
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
    total, weight_sum = _sum(torch.stack([(vw * picked).sum(), vw.sum()]), dp)
    return -total / weight_sum.clamp_min(1e-12)


def weighted_ce_loss(logits: torch.Tensor, target: torch.Tensor, weight: Weight = None,
                     ignore_index: int = -1,
                     target_one_hot_encoded: bool = True, dp=None) -> torch.Tensor:
    """Weighted cross-entropy with data-derived class weights (arXiv
    1707.03237, reference loss.py:144-172): ``(1 - p_c) / p_c`` summed over
    the softmax of the logits, without gradient, times ``weight`` where
    given.  ``target`` is a one-hot (N, C, X, Y, Z) map (argmaxed first) or,
    with ``target_one_hot_encoded=False``, an integer class map."""
    probs = torch.softmax(logits.float(), dim=1)
    flat = flatten_channels(probs)
    complement, total = _sum(torch.stack([(1.0 - flat).sum(-1), flat.sum(-1)]).detach(), dp)
    class_weights = complement / total
    w = _class_weight(weight, logits.shape[1], logits.device)
    if w is not None:
        class_weights = class_weights * w
    if target_one_hot_encoded:
        target = target.argmax(dim=1)
    return ce_loss(logits, target, weight=class_weights, ignore_index=ignore_index, dp=dp)


def bce_with_masking(logits: torch.Tensor, target: torch.Tensor,
                     ignore_index: Optional[int] = -1, skip_last_target: bool = False,
                     with_logits: bool = True, dp=None) -> torch.Tensor:
    """Element-wise binary cross-entropy, mean over every element (reference
    ``BCELossWrapper``, loss.py:175-202): voxels whose target is
    ``ignore_index`` are zeroed in input and target; ``skip_last_target``
    drops the target's last channel.  ``with_logits=False`` takes
    probabilities, clipped to [1e-12, 1 - 1e-12]."""
    if skip_last_target:
        target = target[:, :-1]
    if logits.shape != target.shape:
        raise ValueError(f"shape mismatch: {tuple(logits.shape)} vs {tuple(target.shape)}")
    target = target.float()
    x = logits.float()
    if ignore_index is not None:
        mask = (target != ignore_index).float()
        x = x * mask
        target = target * mask
    if with_logits:
        loss = x.clamp_min(0) - x * target + torch.log1p(torch.exp(-x.abs()))
    else:
        p = x.clamp(1e-12, 1 - 1e-12)
        loss = -(target * torch.log(p) + (1 - target) * torch.log1p(-p))
    return _mean(loss, dp)


def pixelwise_ce_loss(logits: torch.Tensor, labels: torch.Tensor, weights: torch.Tensor,
                      class_weights: Weight = None,
                      ignore_index: Optional[int] = None, dp=None) -> torch.Tensor:
    """Cross-entropy weighted per voxel and per class (reference
    loss.py:204-241): ``mean(-class_w * voxel_w * onehot * log_softmax)``
    over every element of the (N, C, X, Y, Z) logits; ``weights`` is a
    per-voxel map broadcastable to the (N, X, Y, Z) ``labels``."""
    num_classes = logits.shape[1]
    logp = torch.log_softmax(logits.float(), dim=1)
    target = expand_as_one_hot(labels, num_classes, ignore_index=ignore_index)
    w = torch.as_tensor(weights, dtype=torch.float32, device=logits.device)
    w = w.unsqueeze(1).expand(logits.shape)
    if ignore_index is not None:
        mask = (target != ignore_index).float()
        logp = logp * mask
        target = target * mask
    cw = _class_weight(class_weights, num_classes, logits.device)
    if cw is None:
        cw = torch.ones(num_classes, dtype=torch.float32, device=logits.device)
    w = w * cw.view(1, num_classes, *(1,) * (logits.dim() - 2))
    return _mean(-w * target * logp, dp)


def mse_loss(pred: torch.Tensor, target: torch.Tensor, dp=None) -> torch.Tensor:
    return _mean((pred.float() - target.float()) ** 2, dp)


def l1_loss(pred: torch.Tensor, target: torch.Tensor, dp=None) -> torch.Tensor:
    return _mean((pred.float() - target.float()).abs(), dp)


def landmark_loss(logits: torch.Tensor, heatmaps: torch.Tensor, dp=None) -> torch.Tensor:
    """Heatmap-regression MSE (reference ``LandmarkLoss``, loss.py:243-252)."""
    return mse_loss(logits, heatmaps, dp=dp)


def multitask_landmark_loss(output_labels: torch.Tensor, output_heatmaps: torch.Tensor,
                            labels: torch.Tensor, heatmaps: torch.Tensor,
                            regression_weights: Union[torch.Tensor, Sequence[float]],
                            class_loss: str = "DICE",
                            class_weight: Weight = None, regression_loss: str = "L2",
                            dp=None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Segmentation plus landmark loss (reference landmarks.py:125-134):
    ``class_loss(labels) + sum_c regression_weights[c] * reg(heatmap c)``,
    each heatmap channel reduced over every other axis.  Heatmaps are
    (N, L, X, Y, Z); returns (total, class loss, regression loss)."""
    if class_loss == "DICE":
        cls = dice_loss(output_labels, labels, weight=class_weight, dp=dp)
    elif class_loss == "CE":
        cls = ce_loss(output_labels, labels, weight=class_weight, dp=dp)
    else:
        raise ValueError(f"class_loss must be 'DICE' or 'CE', got {class_loss!r}")
    if regression_loss not in ("L2", "L1"):
        raise ValueError(f"regression_loss must be 'L2' or 'L1', got {regression_loss!r}")
    reg_fn = mse_loss if regression_loss == "L2" else l1_loss
    w = torch.as_tensor(regression_weights, dtype=torch.float32, device=output_heatmaps.device)
    per_channel = torch.stack([reg_fn(output_heatmaps[:, c], heatmaps[:, c], dp=dp)
                               for c in range(output_heatmaps.shape[1])])
    reg = (w * per_channel).sum()
    return cls + reg, cls, reg
