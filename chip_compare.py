#!/usr/bin/env python3
"""Two checkouts of tpu_mednet_torch measured in turns on one NVIDIA card.

    python3 chip_compare.py TREE [TREE ...]

Runs one child process per TREE, in the order given (for a parent and a
change: ``_archive/parent . . _archive/parent``), each importing
``tpu_mednet_torch`` from its TREE and building that tree's kernels.  Each
child measures, at the full-width ResidualUNet3D's bf16 shapes:

- the GroupNorm statistics side, every device activity from an
  activation to the per-(n, c) ``mean``/``mul`` (``gn_stats_kernel`` +
  ``gn_combine_kernel`` + the torch fold where the tree has them, else
  ``gn_moments_kernel``): device time and launches per call at each level
  (``torch.profiler``), CUDA-event time per call, and the sum over the
  27 GroupNorms of a forward;
- K2's kernel device time for one batch of 8 tiles of 96^3 (f16 -> bf16);
- one 8x96^3 forward: CUDA-event ms, device time and device launches;
- the slice, ``predict_volumes_on_device`` on ``chip_smoke.py``'s two
  seeded volumes: median volumes/min of 6 calls and the idle share.

Each child prints one JSON line; the parent process prints them all, then
a table.  Exits non-zero without a result when CUDA is unavailable.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np


def child(tree: Path) -> dict:
    import torch

    from chip_smoke import (BATCH, GROUPS, LEVELS, OVERLAP, PATCH, SLICE_VOLUMES,
                            cuda_ms, device_rows)

    sys.path.insert(0, str(tree))
    import tpu_mednet_torch

    if Path(tpu_mednet_torch.__file__).resolve().parent.parent != tree:
        raise RuntimeError(f"imported {tpu_mednet_torch.__file__}, not {tree}'s")
    from tpu_mednet_torch.data import MemoryReader
    from tpu_mednet_torch.inference import predict_volumes_on_device
    from tpu_mednet_torch.inference.device_sliding import _grid_corners
    from tpu_mednet_torch.models import ResidualUNet3D
    from tpu_mednet_torch.ops import _build
    from tpu_mednet_torch.ops import groupnorm as gn
    from tpu_mednet_torch.ops import patches as P
    from tpu_mednet_torch.tasks import SegmentationTask

    _build.build()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    res = dict(tree=str(tree), device=torch.cuda.get_device_name(0),
               moments_kernel=hasattr(gn, "group_norm_moments"), levels=[])

    def stats_side(x, w):
        if res["moments_kernel"]:
            return gn.group_norm_moments(x, GROUPS, w, 1e-5)
        s, q = gn.group_norm_stats(x)
        return gn.fold_group_stats(s, q, x.numel() // (x.shape[0] * x.shape[1]),
                                   GROUPS, w, 1e-5)

    reps = 20
    per_fwd = per_fwd_event = 0.0
    for level, (c, e, n_gn) in enumerate(LEVELS):
        x = (torch.randn((BATCH, e, e, e, c), generator=gen, device=dev) + 0.5)
        x = x.to(torch.bfloat16).permute(0, 4, 1, 2, 3)
        w = torch.rand(c, generator=gen, device=dev) + 0.5
        stats_side(x, w)  # warm-up: the first call allocates the tickets
        rows = device_rows(torch, lambda: stats_side(x, w), reps)
        dev_ms = sum(ms for ms, _, _ in rows)
        launches = sum(n for _, n, _ in rows)
        ev_ms = cuda_ms(lambda: stats_side(x, w))
        res["levels"].append(dict(level=level, shape=list(x.shape), device_ms=dev_ms,
                                  event_ms=ev_ms, launches_per_call=launches,
                                  kernels={name[:60]: ms for ms, _, name in rows}))
        per_fwd += n_gn * dev_ms
        per_fwd_event += n_gn * ev_ms
        del x
    res["stats_side_per_forward_ms"] = per_fwd
    res["stats_side_per_forward_event_ms"] = per_fwd_event

    corners, padded = _grid_corners(SLICE_VOLUMES[0][1], PATCH, OVERLAP)
    vol = torch.randn((*padded.tolist(), 1), generator=gen, device=dev).half()
    gather = lambda: P.extract_patches(vol, corners[:BATCH], PATCH, out_dtype=torch.bfloat16)
    rows = device_rows(torch, gather, reps)
    res["k2_device_ms"] = sum(ms for ms, _, name in rows if "gather" in name.lower())
    res["k2_wrapper_ms"] = cuda_ms(gather)

    torch.backends.cudnn.allow_tf32 = False
    model = ResidualUNet3D(1, 2, f_maps=32, dtype=torch.bfloat16, device=dev,
                           generator=torch.Generator().manual_seed(0))
    xin = torch.randn((BATCH, 1, *PATCH), generator=gen, device=dev)
    with torch.inference_mode():
        res["forward_ms"] = cuda_ms(lambda: model(xin), reps=10, warmup=2)
        rows = [r for r in device_rows(torch, lambda: model(xin), 3)
                if not r[2].startswith(("Memcpy", "Memset"))]
    res["forward_device_ms"] = sum(ms for ms, _, _ in rows)
    res["forward_launches"] = sum(n for _, n, _ in rows)
    res["forward_gn_kernels"] = {name[:60]: [ms, n] for ms, n, name in rows if "gn_" in name}

    rng = np.random.default_rng(0)
    store = {"images": {}}
    for key, shape in SLICE_VOLUMES:
        v = rng.normal(0.0, 0.5, size=(1, *shape)).astype(np.float16)
        v[0, 40:100, 50:110, 30:90] += 2.0
        store["images"][key] = v
    keys = list(store["images"])
    task = SegmentationTask(model=model)

    def predict():
        return predict_volumes_on_device(
            task, None, keys, reader=MemoryReader(store), patch_size=list(PATCH),
            patch_overlap=list(OVERLAP), batch_size=BATCH, device=dev)

    predict()
    walls = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        predict()
        walls.append(time.perf_counter() - t0)
    wall = float(np.median(walls))
    busy = sum(ms for ms, _, _ in device_rows(torch, predict, 1)) / 1e3
    res["slice_seconds"] = walls
    res["slice_volumes_per_min"] = len(keys) / wall * 60.0
    res["slice_idle_share"] = 1 - busy / wall
    return res


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_compare: CUDA is not available; this run needs an NVIDIA card",
              file=sys.stderr)
        return 2
    if len(sys.argv) > 2 and sys.argv[1] == "--child":
        print(json.dumps(child(Path(sys.argv[2]).resolve())), flush=True)
        return 0
    trees = [Path(t).resolve() for t in sys.argv[1:]]
    if not trees:
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    results = []
    for tree in trees:
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--child",
                               str(tree)], capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        results.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        results[-1]["card"] = smi
        print(json.dumps(results[-1]), flush=True)
    print(f"{'tree':<36} {'L0 dev':>8} {'L1 dev':>8} {'L2 dev':>8} {'L3 dev':>8} "
          f"{'L4 dev':>8} {'launch':>6} {'stats/fwd':>9} {'K2 dev':>8} {'fwd ms':>8} "
          f"{'fwd dev':>8} {'fwd launches':>12} {'vol/min':>8} {'idle':>6}")
    for r in results:
        lv = r["levels"]
        print(f"{r['tree'][-36:]:<36} " + " ".join(f"{x['device_ms']:8.4f}" for x in lv)
              + f" {lv[0]['launches_per_call']:6d} {r['stats_side_per_forward_ms']:9.4f}"
              f" {r['k2_device_ms']:8.4f} {r['forward_ms']:8.3f} {r['forward_device_ms']:8.3f}"
              f" {r['forward_launches']:12d} {r['slice_volumes_per_min']:8.2f}"
              f" {r['slice_idle_share']:6.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
