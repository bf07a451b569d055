"""The general training loop: the program's train step fed by its device sampler.

Set-up builds one train state (the seeded weights in the program's model,
``create_train_state`` with the family's optimizer, ``make_train_step``
with the mix's augmentation)
and one endless feed of ``DevicePatchSampler`` batches, and drives them
through the first steps with the window's own call; those are the steps the
reference follows.  The window then dispatches steps back to back for
``seconds`` and closes with a device synchronisation.  With ``trace`` a
short stretch in the middle of the window runs under the profiler, and the
host time of every batch drawn from the sampler is summed.

Traffic parameters: ``batch``, ``patch``, ``subjects`` (extents),
``samples_per_subject``, ``class_probabilities`` (or null),
``landmarks_per_subject`` and ``heatmap_sigma`` (landmark configurations),
``augment`` (the fields of the program's ``AugmentConfig``),
``first_steps`` (the steps the reference follows), ``warmup_steps`` (more
steps before the window), ``trace_steps`` (the profiled stretch),
``reference_rows`` (rows a reference pass).
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import record_function

from h100bench import counting, data, harness, trace
from h100bench.reference import train as ref_train


def _sampler(cell, store, seeds):
    from tpu_mednet_torch.data import DevicePatchSampler, MemoryReader

    t = cell.traffic
    kw = {}
    if t.get("landmarks_per_subject"):
        kw = {"landmark_group": "landmarks", "heatmap_sigma": float(t["heatmap_sigma"])}
    return DevicePatchSampler(None, list(store["images"]), int(t["samples_per_subject"]),
                              t["patch"], reader=MemoryReader(store),
                              class_probabilities=t.get("class_probabilities"),
                              seed=seeds["sampler"], device=cell.device, **kw)


def _feed(sampler, batch):
    while True:
        yield from sampler.batches(batch)


def _grad_norms(state, names) -> dict:
    """Each leaf's first gradient, from Adam's (or AdamW's) first moment
    after one step."""
    beta1 = state.optimizer.param_groups[0]["betas"][0]
    out = {}
    for name, p in zip(names, state.params):
        m = state.optimizer.state.get(p, {}).get("exp_avg")
        out[name] = 0.0 if m is None else float(m.norm()) / (1.0 - beta1)
    return out


def _plant(cell, task, state):
    """The planted fault of a test, in the program's timed path."""
    if cell.fault == "unchanged":
        state.optimizer.step = lambda *a, **k: None
    elif cell.fault == "convs_unmoved":
        # every convolution's weight put back after each update (Adam's
        # moments still kept): the median leaf, a GroupNorm leaf, moves
        convs = [p for p in state.params if p.dim() == 5]
        update = state.optimizer.step

        def without_convs(*a, **k):
            before = [p.detach().clone() for p in convs]
            out = update(*a, **k)
            with torch.no_grad():
                torch._foreach_copy_(convs, before)
            return out
        state.optimizer.step = without_convs
    elif cell.fault == "half_batch":
        orig = task.loss_fn

        def half(outputs, batch, dp=None):
            n = outputs.shape[0] // 2
            return orig(outputs[:n], {k: v[:n] for k, v in batch.items()}, dp=dp)
        task.loss_fn = half


def run(cell) -> dict:
    from tpu_mednet_torch.ops.augment import AugmentConfig
    from tpu_mednet_torch.train import OptimizerConfig, create_train_state, make_train_step

    t, cfg, dev, fam = cell.traffic, cell.cfg, cell.device, cell.family
    seeds = data.seeds(cell.seed)
    n_classes = int(cfg["out_channels"]) - len(cfg.get("loss_regression_weight") or [])
    store = data.training_subjects(t, n_classes, cell.seed, dev)
    task = fam.port_task(cfg, data.weights(fam, cfg, cell.seed, dev), dev)
    names = [n for n, _ in task.model.named_parameters()]
    state = create_train_state(task.model, seed=seeds["augment"],
                               optimizer=OptimizerConfig(**fam.optimizer(cfg)))
    _plant(cell, task, state)
    aug = {k: tuple(v) if isinstance(v, list) else v for k, v in t["augment"].items()}
    step = make_train_step(task, augment=AugmentConfig(**aug))
    feed = _feed(_sampler(cell, store, seeds), int(t["batch"]))

    start = [p.detach().clone() for p in state.params]
    first_losses, grad_norms = [], {}
    for i in range(int(t["first_steps"])):
        state, metrics = step(state, next(feed))
        first_losses.append(metrics["train_loss"])
        if i == 0:
            grad_norms = _grad_norms(state, names)
    change = {n: float((p.detach() - s).norm()) for n, p, s in zip(names, state.params, start)}
    del start
    for _ in range(int(t["warmup_steps"])):
        state, metrics = step(state, next(feed))
    harness.sync(dev)
    setup_s = time.perf_counter() - cell.t_start

    setup_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    losses, sampler_s, stretches = [], 0.0, []
    marks = [0.3, 0.6] if cell.trace else []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < cell.seconds:
        if marks and time.perf_counter() - t0 >= marks[0] * cell.seconds:
            marks.pop(0)
            with trace.Stretch(harness.k1_launches, fam.KERNEL_GROUPS) as s:
                for _ in range(int(t["trace_steps"])):
                    with record_function("h100bench.sampler"):
                        batch = next(feed)
                    with record_function("h100bench.step"):
                        state, metrics = step(state, batch)
                    losses.append(metrics["train_loss"])
            stretches.append(s)
            continue
        a = time.perf_counter()
        batch = next(feed)
        sampler_s += time.perf_counter() - a
        state, metrics = step(state, batch)
        losses.append(metrics["train_loss"])
    harness.sync(dev)
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    losses = [float(v) for v in losses]
    first_losses = [float(v) for v in first_losses]

    n_steps, batch, patch = len(losses), int(t["batch"]), t["patch"]
    step_flops = counting.train_step_flops(fam.forward_flops(cfg, patch), batch)
    traced = len(stretches) * int(t["trace_steps"])
    record = {
        "setup_s": setup_s, "window_s": window_s, "patches": n_steps * batch,
        "window_peak_bytes": peak, "memory_peak_bytes": max(peak, setup_peak),
        # the window's work and time outside the profiled stretches
        "flops": (n_steps - traced) * step_flops,
        "untraced_s": window_s - sum(s.host_s for s in stretches),
        "sampler_s": sampler_s, "sampled_steps": n_steps - traced,
        "attempted": n_steps, "failed": sum(not np.isfinite(v) for v in losses),
    }
    readings = [s.read() for s in stretches]
    if readings:
        r = max(readings, key=lambda r: r["kept"])
        r["steps"] = int(t["trace_steps"])
        r["flops"] = r["steps"] * step_flops
        r["conv_flops"] = r["steps"] * counting.train_step_flops(fam.conv_flops(cfg, patch),
                                                                 batch)
        norms = fam.norm_layers(cfg, patch)
        r["k1_bytes"] = r["steps"] * (counting.k1_forward_bytes(cfg, norms, batch)
                                      + counting.k1_backward_bytes(cfg, norms, batch))
        r["work"] = counting.scaled(fam.group_work(cfg, patch, True), r["steps"] * batch)
        if r["kept"] >= trace.MIN_KEPT:
            record["stretch"] = r

    del state, step, task, feed, metrics
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    program = {"losses": first_losses, "grad_norms": grad_norms, "change_norms": change}
    ref = reference_readings(cell, store)
    record["readings"] = {"program": program, "reference": ref}
    record["checks"] = ref_train.compare(program, ref)
    return record


def reference_readings(cell, store, **kw) -> dict:
    """The reference's readings of the cell's first steps (``kw``: a
    rounding of the conv operands, or the half-batch fault, for the
    comparison's own checks)."""
    cfg, dev, fam = cell.cfg, cell.device, cell.family
    params = {k: v.clone().requires_grad_()
              for k, v in data.weights(fam, cfg, cell.seed, dev).items()}
    return ref_train.first_steps(fam, cfg, cell.traffic, store, params, data.seeds(cell.seed),
                                 dev, n_steps=int(cell.traffic["first_steps"]),
                                 rows=int(cell.traffic["reference_rows"]), **kw)
