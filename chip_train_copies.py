#!/usr/bin/env python3
"""Which operations of the training step launch its copy kernels, on one NVIDIA card.

    python3 chip_train_copies.py

Runs the full-width bf16 training step of ``chip_smoke.py`` (``ResidualUNet3D``
f_maps 32, batch 32 of 96^3, Dice, Adam, mirror flips; random data of the
sampler's layout, no sampler) for two warm-up steps, then profiles one step
with ``torch.profiler`` and its input shapes.  Every device kernel whose name
holds ``copy`` is charged to the operator that launched it; the script prints
the copies' device ms per step in all, then the largest groups by launching
operator, each with its chain of enclosing operators and their input shapes.
It also prints the strides of the first convolution's bf16 weight and of the
model's input as the forward hands them to cuDNN.  Exits non-zero without a
result when CUDA is unavailable.
"""

from __future__ import annotations

import sys
from collections import defaultdict
from pathlib import Path

HERE = Path(__file__).resolve().parent
BATCH, PATCH = 32, (96, 96, 96)
TOP = 10


def chain(evt, depth=8):
    """The operator names from ``evt`` out to its outermost parent, with the
    input shapes of those that record them."""
    out = []
    while evt is not None and len(out) < depth:
        shapes = [s for s in (getattr(evt, "input_shapes", None) or []) if s]
        out.append(f"{evt.name}{shapes if shapes else ''}")
        evt = evt.cpu_parent
    return " < ".join(out)


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("chip_train_copies: CUDA is not available; this run needs an NVIDIA card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    from tpu_mednet_torch.models import ResidualUNet3D
    from tpu_mednet_torch.models.blocks import _conv_weight
    from tpu_mednet_torch.ops.augment import AugmentConfig
    from tpu_mednet_torch.tasks import SegmentationTask
    from tpu_mednet_torch.train import create_train_state, make_train_step

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    model = ResidualUNet3D(1, 2, f_maps=32, dtype=torch.bfloat16, device=dev,
                           generator=torch.Generator().manual_seed(0))
    task = SegmentationTask(model=model, loss="DICE")
    state = create_train_state(model, learning_rate=1e-3, seed=0)
    step = make_train_step(task, augment=AugmentConfig(mirror_axes=(1, 2, 3)))
    # the sampler's layout: channels_last_3d views of (N, X, Y, Z, C) windows
    data = torch.randn((BATCH, *PATCH, 1), generator=gen, device=dev).to(torch.bfloat16)
    label = (torch.rand((BATCH, *PATCH, 1), generator=gen, device=dev) > 0.7).to(torch.uint8)
    batch = {"data": data.permute(0, 4, 1, 2, 3), "label": label.permute(0, 4, 1, 2, 3)}

    first = next(m for m in model.modules() if isinstance(m, torch.nn.Conv3d))
    w = _conv_weight(first.weight, torch.bfloat16)
    x = batch["data"].contiguous(memory_format=torch.channels_last_3d)
    print(f"first conv: weight {tuple(w.shape)} strides {w.stride()}, input {tuple(x.shape)} "
          f"strides {x.stride()}; NCDHW-contiguous: weight {w.is_contiguous()}, "
          f"input {x.is_contiguous()}", flush=True)

    for _ in range(2):
        state, _ = step(state, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
    if not bool(torch.isfinite(metrics["train_loss"])):
        raise AssertionError("non-finite loss")

    groups = defaultdict(lambda: [0.0, 0, ""])
    total_us = 0.0
    for evt in prof.events():
        for k in getattr(evt, "kernels", None) or []:
            if "copy" not in k.name.lower():
                continue
            key = chain(evt)
            groups[key][0] += k.duration
            groups[key][1] += 1
            groups[key][2] = k.name
            total_us += k.duration
    if not groups:
        raise AssertionError("the profile attributed no copy kernel to an operator")
    print(f"copy kernels: {sum(g[1] for g in groups.values())} launches, "
          f"{total_us / 1e3:.3f} ms device time in the step (NVIDIA card, bf16, "
          f"batch {BATCH} of 96^3)", flush=True)
    for key, (us, count, name) in sorted(groups.items(), key=lambda kv: -kv[1][0])[:TOP]:
        print(f"{us / 1e3:8.3f} ms  x{count:<3d} {name[:70]}\n           {key[:600]}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
