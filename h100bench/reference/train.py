"""The reference of a training cell's first steps, in plain PyTorch and numpy.

It draws the same batches as the program's device sampler is specified to
(the reference's class-balanced corners, ``midasmednet/dataset.py:18-88``:
an epoch is a permutation of each subject repeated ``samples_per_subject``
times; per patch a class from ``class_probabilities``, a voxel of it by the
two-stage draw over the axis-2 any-mask, then a corner that keeps it in
the patch), cuts the windows from the benchmark's own host volumes,
renders landmark heatmaps (separable Gaussians of amplitude 255 in
patch-local coordinates, truncated to uint8), draws the augmentation from
a ``torch.Generator`` seeded as the program's step is (the configured
ones of brightness N(0, sigma) per sample and channel, gamma per sample
and contrast per sample and channel uniform in their ranges, then mirror
flips with p 0.5 per axis and sample, in that order), and runs the
family's network (its ``forward``), loss (its ``reference_loss``; ``Loss``
here: soft Dice over the softmax, per-class weights on the intersection;
for landmarks plus the weighted per-heatmap MSE) and optimizer (its
``reference_update``; ``adam_`` here: Adam, or AdamW with a weight decay)
in float32.

A batch too large for one pass runs in blocks of rows: a first pass
without gradients sums the Dice terms over the whole batch, a second one
backpropagates each block through the loss linearised at those sums, which
is the exact gradient of the whole batch's loss.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from h100bench.reference.precision import exact_fp32

DICE_EPS = 1e-5
BETAS, ADAM_EPS = (0.9, 0.999), 1e-8


class Sampler:
    """The program's seeded batches, drawn again from the same host data."""

    def __init__(self, data: dict, traffic: dict, seed: int):
        self.images = data["images"]          # key -> (C, X, Y, Z) float32
        self.labels = data["labels"]          # key -> (1, X, Y, Z) uint8 class map
        self.landmarks = data.get("landmarks")  # key -> (L, 3) float32
        self.keys = list(self.images)
        self.patch = np.asarray(traffic["patch"], dtype=np.int64)
        self.sps = int(traffic["samples_per_subject"])
        self.batch = int(traffic["batch"])
        self.sigma = float(traffic.get("heatmap_sigma", 4.0))
        p = traffic.get("class_probabilities")
        self.probs = None if p is None else np.asarray(p, np.float64) / np.sum(p)
        self.rng = np.random.default_rng(seed)
        self.any = []
        if self.probs is not None:
            for k in self.keys:
                cm = self.labels[k][-1]
                self.any.append([None] + [np.any(cm == c, axis=2)
                                          for c in range(1, len(self.probs))])

    def _corner(self, s: int) -> np.ndarray:
        shape = np.asarray(self.images[self.keys[s]].shape[1:], dtype=np.int64)
        pos = None
        if self.probs is not None:
            cls = int(self.rng.choice(len(self.probs), p=self.probs))
            if cls > 0:
                cells = np.argwhere(self.any[s][cls])
                if cells.size:
                    cell = cells[self.rng.integers(0, cells.shape[0])]
                    column = self.labels[self.keys[s]][-1][cell[0], cell[1], :]
                    z = int(self.rng.choice(np.flatnonzero(column == cls)))
                    pos = np.array([int(cell[0]), int(cell[1]), z], dtype=np.int64)
        if pos is None:
            lo, hi = np.zeros(3, np.int64), shape - self.patch + 1
        else:
            lo = np.maximum(pos - self.patch + 1, 0)
            hi = np.minimum(shape - self.patch + 1, pos + 1)
        return self.rng.integers(low=lo, high=hi)

    def batches(self) -> Iterator[dict]:
        items = np.repeat(np.arange(len(self.keys), dtype=np.int64), self.sps)
        while True:
            order = self.rng.permutation(items)
            for start in range(0, len(order) - self.batch + 1, self.batch):
                subj = order[start:start + self.batch]
                corners = [self._corner(int(s)) for s in subj]
                yield self._cut(subj, corners)

    def _cut(self, subj, corners) -> dict:
        px, py, pz = (int(v) for v in self.patch)
        data, label = [], []
        for s, (x, y, z) in zip(subj, corners):
            k = self.keys[int(s)]
            data.append(self.images[k][:, x:x + px, y:y + py, z:z + pz])
            lbl = self.labels[k][:, x:x + px, y:y + py, z:z + pz]
            if self.landmarks is not None:
                local = self.landmarks[k] - np.asarray([x, y, z], np.float32)
                lbl = np.concatenate([render_heatmaps(local, (px, py, pz), self.sigma), lbl])
            label.append(lbl)
        return {"data": torch.from_numpy(np.stack(data)),
                "label": torch.from_numpy(np.stack(label))}


def render_heatmaps(local: np.ndarray, shape: Sequence[int], sigma: float) -> np.ndarray:
    """(L, X, Y, Z) uint8 Gaussians of amplitude 255 centred on ``local``."""
    c = torch.from_numpy(np.asarray(local, np.float32))
    inv = 1.0 / (2.0 * sigma * sigma)
    e = [torch.exp(-((torch.arange(n, dtype=torch.float32) - c[:, a, None]) ** 2) * inv)
         for a, n in enumerate(shape)]
    hm = (e[0][:, :, None, None] * e[1][:, None, :, None] * e[2][:, None, None, :]) * 255.0
    return hm.to(torch.uint8).numpy()


def augment(x: torch.Tensor, label: torch.Tensor, aug: dict, gen: torch.Generator):
    """The configured transforms on fp32 (N, C, X, Y, Z) data and its label,
    with draws from ``gen`` (a generator on the device of ``x``)."""
    n, c = x.shape[:2]
    dev = gen.device
    sigma = float(aug.get("brightness_sigma", 0.0))
    if sigma > 0:
        off = 0.0 + sigma * torch.randn((n, c), generator=gen, device=dev)
        x = x + off.view(n, c, 1, 1, 1)
    if aug.get("gamma_range"):
        lo, hi = aug["gamma_range"]
        g = lo + (hi - lo) * torch.rand((n,), generator=gen, device=dev)
        dims = (1, 2, 3, 4)
        mn = x.amin(dim=dims, keepdim=True)
        span = x.amax(dim=dims, keepdim=True) - mn
        xn = (x - mn) / (span + 1e-7)
        x = torch.pow(xn.clamp(1e-7, 1.0), g.view(n, 1, 1, 1, 1)) * span + mn
    if aug.get("contrast_range"):
        lo, hi = aug["contrast_range"]
        f = lo + (hi - lo) * torch.rand((n, c), generator=gen, device=dev)
        sp = (2, 3, 4)
        m = x.mean(dim=sp, keepdim=True)
        y = (x - m) * f.view(n, c, 1, 1, 1) + m
        x = torch.clamp(y, x.amin(dim=sp, keepdim=True), x.amax(dim=sp, keepdim=True))
    axes = tuple(aug.get("mirror_axes", ()))
    if axes:
        flips = torch.rand((len(axes), n), generator=gen, device=dev) < 0.5
        for ax, flip in zip(axes, flips):
            f5 = flip.view(-1, 1, 1, 1, 1)
            x = torch.where(f5, x.flip(ax + 1), x)
            label = torch.where(f5, label.flip(ax + 1), label)
    return x, label


def _dice_terms(logits: torch.Tensor, classes: torch.Tensor):
    """Per-class (intersection, denominator) sums of the softmax against the
    one-hot labels."""
    p = torch.softmax(logits, dim=1)
    t = F.one_hot(classes.long(), logits.shape[1]).movedim(-1, 1).float()
    dims = (0, 2, 3, 4)
    return (p * t).sum(dims), (p + t).sum(dims)


class Loss:
    """The cell's loss on logits and a label batch, whole or linearised."""

    def __init__(self, cfg: dict):
        self.landmarks = cfg["task"] == "landmarks"
        self.reg_w = cfg.get("loss_regression_weight") or []
        w = cfg.get("loss_class_weight") if self.landmarks else cfg.get("loss_weight")
        self.class_w = w

    def split(self, logits, label):
        h = len(self.reg_w) if self.landmarks else 0
        return logits[:, h:], label[:, -1], logits[:, :h], label[:, :-1].float()

    def _w(self, n, dev):
        return (torch.ones(n, device=dev) if self.class_w is None
                else torch.tensor(self.class_w, dtype=torch.float32, device=dev))

    def terms(self, logits, label) -> dict:
        """The batch sums the loss is made of."""
        cls, classes, hm_out, hm = self.split(logits, label)
        i, d = _dice_terms(cls, classes)
        out = {"i": i, "d": d}
        if self.landmarks:
            out["sq"] = torch.stack([((hm_out[:, k] - hm[:, k]) ** 2).sum()
                                     for k in range(hm.shape[1])])
            out["count"] = torch.tensor(float(hm[:, 0].numel()), device=logits.device)
        return out

    def value(self, t: dict) -> torch.Tensor:
        w = self._w(t["i"].numel(), t["i"].device)
        dice = 2.0 * w * t["i"] / t["d"].clamp_min(DICE_EPS)
        loss = (1.0 - dice).mean()
        if self.landmarks:
            reg = torch.tensor(self.reg_w, device=loss.device)
            loss = loss + (reg * t["sq"] / t["count"]).sum()
        return loss

    def linearised(self, t: dict, total: dict) -> torch.Tensor:
        """A function of this block's sums ``t`` whose gradient is the whole
        loss's, given the whole batch's sums ``total`` (constants)."""
        w = self._w(t["i"].numel(), t["i"].device)
        n = t["i"].numel()
        d = total["d"].clamp_min(DICE_EPS)
        out = (-2.0 * w / (n * d) * t["i"] + 2.0 * w * total["i"] / (n * d * d) * t["d"]).sum()
        if self.landmarks:
            reg = torch.tensor(self.reg_w, device=out.device)
            out = out + (reg * t["sq"] / total["count"]).sum()
        return out


def _add(a: Optional[dict], b: dict) -> dict:
    return {k: v.detach() for k, v in b.items()} if a is None else \
        {k: a[k] + b[k].detach() for k in a}


def loss_and_grads(forward: Callable, cfg: dict, params: Dict[str, torch.Tensor],
                   x: torch.Tensor, label: torch.Tensor, loss: Loss, rows: int,
                   quant: Optional[Callable] = None):
    """(loss, {name: gradient}) of the batch through the reference
    ``forward``, ``rows`` rows a pass."""
    for p in params.values():
        p.grad = None
    n = x.shape[0]
    if rows >= n:
        value = loss.value(loss.terms(forward(cfg, params, x, quant), label))
        value.backward()
        return float(value.detach()), {k: p.grad for k, p in params.items()}
    total = None
    with torch.no_grad():
        for s in range(0, n, rows):
            total = _add(total, loss.terms(forward(cfg, params, x[s:s + rows], quant),
                                           label[s:s + rows]))
        if "count" in total:
            total["count"] = torch.tensor(float(label[:, 0].numel()), device=x.device)
    for s in range(0, n, rows):
        t = loss.terms(forward(cfg, params, x[s:s + rows], quant), label[s:s + rows])
        t.pop("count", None)
        loss.linearised(t, total).backward()
    return float(loss.value(total)), {k: p.grad for k, p in params.items()}


@torch.no_grad()
def adam_(params: Dict[str, torch.Tensor], grads, m, v, step: int, lr: float,
          weight_decay: float = 0.0) -> None:
    """Adam, torch's and optax's; with ``weight_decay``, AdamW (the decay
    decoupled: each parameter first scaled by 1 - lr x weight_decay)."""
    b1, b2 = BETAS
    for k, p in params.items():
        g = grads[k]
        if weight_decay:
            p.mul_(1.0 - lr * weight_decay)
        m[k].mul_(b1).add_(g, alpha=1 - b1)
        v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
        m_hat = m[k] / (1 - b1 ** step)
        v_hat = v[k] / (1 - b2 ** step)
        p.sub_(lr * m_hat / (v_hat.sqrt() + ADAM_EPS))


def first_steps(family, cfg: dict, traffic: dict, data: dict,
                params: Dict[str, torch.Tensor], seeds: dict, device, n_steps: int = 3,
                rows: int = 8, quant: Optional[Callable] = None,
                half_batch: bool = False) -> dict:
    """The readings of the cell's first ``n_steps`` steps from ``params``
    (fp32, on ``device``; updated in place) through the reference of
    ``family`` (its module under ``families/``): each step's loss, each
    leaf's norm of the first gradient, and of the change after
    ``n_steps``.  ``half_batch`` takes the loss over the first half of
    each batch only (a fault the comparison must catch)."""
    with exact_fp32():
        return _first_steps(family, cfg, traffic, data, params, seeds, device, n_steps, rows,
                            quant, half_batch)


def _first_steps(family, cfg, traffic, data, params, seeds, device, n_steps, rows, quant,
                 half_batch):
    sampler = Sampler(data, traffic, seeds["sampler"]).batches()
    gen = torch.Generator(device=device).manual_seed(seeds["augment"])
    loss = family.reference_loss(cfg)
    start = {k: p.detach().clone() for k, p in params.items()}
    m = {k: torch.zeros_like(p) for k, p in params.items()}
    v = {k: torch.zeros_like(p) for k, p in params.items()}
    losses, first = [], {}
    for step in range(1, n_steps + 1):
        batch = next(sampler)
        x = batch["data"].to(device, torch.float32)
        label = batch["label"].to(device)
        x, label = augment(x, label, traffic.get("augment", {}), gen)
        if half_batch:
            x, label = x[: x.shape[0] // 2], label[: label.shape[0] // 2]
        value, grads = loss_and_grads(family.forward, cfg, params, x, label, loss, rows,
                                      quant)
        losses.append(value)
        if step == 1:
            first = {k: float(g.norm()) for k, g in grads.items()}
        family.reference_update(cfg, params, grads, m, v, step)
    change = {k: float((p.detach() - start[k]).norm()) for k, p in params.items()}
    return {"losses": losses, "grad_norms": first, "change_norms": change}


def leaf_gaps(got: Dict[str, float], want: Dict[str, float], keep: List[str]) -> Dict[str, float]:
    """Each kept leaf's gap between two norms, against the reference's norm
    of that leaf or of the median leaf, whichever is larger."""
    med = float(np.median([want[k] for k in keep]))
    return {k: abs(got[k] - want[k]) / max(want[k], med) for k in keep}


def kept_leaves(want: dict) -> List[str]:
    """Leaves whose reference first gradient is at least a thousandth of
    the median leaf's (the others' Adam steps are round-off)."""
    g = want["grad_norms"]
    med = float(np.median(list(g.values())))
    return [k for k in g if g[k] >= 1e-3 * med]


def compare(got: dict, want: dict) -> Dict[str, float]:
    """The numbers a training cell may compare (its limits file names
    which): the largest relative gap of a step's loss; the worst leaf's
    gap of the first gradient's norm, and the mean of the leaves' gaps
    (``grad_gap_mean``, steady where one seed's worst leaf is not,
    PERF.md); the median leaf's gap of the change's norm after the steps;
    and the worst leaf's (``change_gap_worst``), which a leaf left unmoved
    reads as 1 and which reads a few hundredths in sound runs (small
    GroupNorm leaves whose Adam steps change sign, PERF.md)."""
    keep = kept_leaves(want)
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], want["losses"]))
    grad = leaf_gaps(got["grad_norms"], want["grad_norms"], keep)
    change = leaf_gaps(got["change_norms"], want["change_norms"], keep)
    return {"loss_gap": loss_gap,
            "grad_gap": max(grad.values()),
            "grad_gap_mean": float(np.mean(list(grad.values()))),
            "change_gap": float(np.median(list(change.values()))),
            "change_gap_worst": max(change.values())}


def unchanged(want: dict) -> dict:
    """The program's readings had its step left the state unchanged: no
    optimizer state, no change (the losses are not read: the reference's)."""
    zero = {k: 0.0 for k in want["grad_norms"]}
    return {"losses": want["losses"], "grad_norms": zero, "change_norms": dict(zero)}
