"""The general serving loop: one caller, one volume a call, in a closed loop.

The pool's volumes (host f16, made from the seed) are read through a
``MemoryReader``; each request is one call of the program's
``predict_volumes_on_device`` on one volume, timed from the call to the
uint8 mask on the host.  Every pass over the pool takes a new seeded order,
so any window holds nearly the pool's mix.  Set-up warms the entry up on
the smallest volume.  With ``trace`` a stretch of requests in the middle of
the window runs under the profiler.

Every mask is checked for its shape and type as it comes, and once the
window has closed each volume's last mask for its classes; the reference
judges a sample of those drawn from the seed, with the largest volume
served in it.

Traffic parameters: ``pool`` (extents), ``patch``, ``overlap``, ``batch``,
``tta_flips``, ``warmup_requests``, ``trace_requests``, ``judged``
(volumes the reference judges), ``reference_rows`` (tiles a reference
forward).
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import record_function

from h100bench import counting, data, harness, trace
from h100bench.reference import serve as ref_serve


def _orders(n: int, seed: int):
    rng = np.random.default_rng(data.sub_seed(seed, "order"))
    while True:
        yield from rng.permutation(n).tolist()


def run(cell) -> dict:
    from tpu_mednet_torch.data import MemoryReader
    from tpu_mednet_torch.inference import predict_volumes_on_device

    t, cfg, dev, fam = cell.traffic, cell.cfg, cell.device, cell.family
    pool = data.serving_pool(t, cell.seed, dev)
    keys = sorted(pool)
    task = fam.port_task(cfg, data.weights(fam, cfg, cell.seed, dev), dev)
    reader = MemoryReader({"images": pool})
    n_classes = int(cfg["out_channels"])

    def request(key):
        out = predict_volumes_on_device(
            task, None, [key], t["patch"], t["overlap"], batch_size=int(t["batch"]),
            reader=reader, device=dev, tta_flips=tuple(t["tta_flips"]))
        mask = out[key].array
        if cell.fault == "altered":
            mask[0, : mask.shape[1] // 2] = (mask[0, : mask.shape[1] // 2] + 1) % n_classes
        return mask

    smallest = min(keys, key=lambda k: pool[k].size)
    for _ in range(int(t["warmup_requests"])):
        request(smallest)
    harness.sync(dev)
    setup_s = time.perf_counter() - cell.t_start
    setup_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    order = _orders(len(keys), cell.seed)
    latencies, served, kept, failed = [], [], {}, 0
    stretches, traced = [], []
    marks = [0.3, 0.6] if cell.trace else []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < cell.seconds:
        if marks and time.perf_counter() - t0 >= marks[0] * cell.seconds:
            marks.pop(0)
            keys_in = [keys[next(order)] for _ in range(int(t["trace_requests"]))]
            with trace.Stretch(harness.k1_launches, fam.KERNEL_GROUPS) as s:
                for key in keys_in:
                    with record_function("h100bench.request"):
                        mask = request(key)
                    failed += _bad(mask, pool[key])
            stretches.append(s)
            traced.append(keys_in)
            continue
        key = keys[next(order)]
        a = time.perf_counter()
        mask = request(key)
        latencies.append(time.perf_counter() - a)
        served.append(key)
        kept[key] = mask
        failed += _bad(mask, pool[key])
    window_s = time.perf_counter() - t0
    failed += sum(int(m.max()) >= n_classes for m in kept.values())
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    done = len(served) + sum(len(k) for k in traced)
    per_tile = fam.forward_flops(cfg, t["patch"])
    conv_tile = fam.conv_flops(cfg, t["patch"])
    norms = fam.norm_layers(cfg, t["patch"])
    tile_work = fam.group_work(cfg, t["patch"], False)

    def grid_tiles(keys_):
        return sum(data.extent_tiles(pool[k].shape[1:], t["patch"], t["overlap"]) for k in keys_)

    def batch_tiles(keys_):
        b = int(t["batch"])
        return sum(-(-data.extent_tiles(pool[k].shape[1:], t["patch"], t["overlap"]) // b) * b
                   for k in keys_)

    record = {
        "setup_s": setup_s, "window_s": window_s, "requests": done,
        "latencies": latencies, "memory_peak_bytes": max(peak, setup_peak),
        # the window's work and time outside the profiled stretches
        "flops": grid_tiles(served) * per_tile,
        "untraced_s": window_s - sum(s.host_s for s in stretches),
        "attempted": done, "failed": failed,
    }
    readings = [dict(s.read(), requests=len(k), flops=grid_tiles(k) * per_tile,
                     conv_flops=batch_tiles(k) * conv_tile,
                     k1_bytes=counting.k1_forward_bytes(cfg, norms, batch_tiles(k)),
                     k2_bytes=counting.k2_bytes(cfg, t["patch"], batch_tiles(k)),
                     work=counting.scaled(tile_work, batch_tiles(k)))
                for s, k in zip(stretches, traced)]
    if readings:
        r = max(readings, key=lambda r: r["kept"])
        if r["kept"] >= trace.MIN_KEPT:
            record["stretch"] = r

    del task
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    record["judged"] = judged_keys(cell, kept, pool)
    record["checks"] = {"logit_gap": judge(cell, pool, kept, record["judged"])}
    return record


def _bad(mask: np.ndarray, volume: np.ndarray) -> int:
    """1 for a mask of the wrong shape or type (its classes are checked
    once the window has closed, on each volume's last mask)."""
    return int(mask.shape != volume.shape or mask.dtype != np.uint8)


def judged_keys(cell, kept: dict, pool: dict) -> list:
    """The largest volume served and ``judged - 1`` more drawn from the seed."""
    if not kept:
        return []
    keys = sorted(kept)
    largest = max(keys, key=lambda k: pool[k].size)
    rest = [k for k in keys if k != largest]
    rng = np.random.default_rng(data.sub_seed(cell.seed, "sample"))
    n = min(int(cell.traffic["judged"]) - 1, len(rest))
    return [largest] + [rest[i] for i in sorted(rng.choice(len(rest), n, replace=False))]


def judge(cell, pool: dict, kept: dict, keys: list) -> float:
    """The widest logit gap of the masks of ``keys`` under the reference."""
    if not keys:
        return float("inf")
    t, cfg, dev, fam = cell.traffic, cell.cfg, cell.device, cell.family
    params = data.weights(fam, cfg, cell.seed, dev)
    return max(ref_serve.widest_gap(fam, cfg, params, pool[k], kept[k], t["patch"],
                                    t["overlap"], int(t["reference_rows"]), dev)
               for k in keys)
