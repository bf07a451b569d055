"""One run of one cell: find its files by name, drive its loop, judge and report.

A cell of ``BENCHMARK.json`` names a configuration (its file, a JSON object
of the model's sizes and the task's loss and optimizer) and a traffic mix
(``traffic/<name>.json``: which general loop drives the program, ``train``
or ``serve``, and its parameters).  The loop returns a record of what it
saw; each metric is read from the record by ``metrics/<name>.py`` (or, for
a name with a dot, the module of the part before it); the correctness
limits of the cell are ``limits/<workload>.json``.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from typing import Dict, Optional

import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_mednet")

# What the port's builder (``port_task``), the reference and ``counting``
# implement.  A configuration naming anything else is refused before a run:
# it would otherwise be measured, and judged, as this family.  Another family
# comes with its own builder, reference and count, and its values here.
IMPLEMENTED = {
    "model": ("ResidualUNet3D",),
    "join": ("transposed_conv_sum",),
    "layer_order": ("cge",),
    "optimizer": ("adam",),
    "task": ("segmentation", "landmarks"),
    "loss": ("DICE",),
    "loss_class": ("DICE",),
    "loss_regression": ("L2",),
}
OPTIONAL = ("loss", "loss_class", "loss_regression")  # keys of one task only


def check_config(cfg: dict, where: str) -> None:
    """Refuse a configuration the harness does not implement."""
    for key, known in IMPLEMENTED.items():
        if key in OPTIONAL and key not in cfg:
            continue
        if cfg.get(key) not in known:
            raise SystemExit(f"{where}: {key} {cfg.get(key)!r} is not implemented by "
                             f"h100bench (it implements {', '.join(known)})")


@dataclasses.dataclass
class Cell:
    name: str
    cfg: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    fault: Optional[str] = None      # a planted fault (tests of the comparison only)
    t_start: float = dataclasses.field(default_factory=time.perf_counter)


def load_cell(workload: str, seed: int, seconds: float, trace: bool, device,
              bench: Optional[dict] = None, t_start: Optional[float] = None) -> Cell:
    bench = bench or json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    cfg = json.loads((ROOT / conf["file"]).read_text())
    check_config(cfg, conf["file"])
    traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())
    limits = json.loads((HERE / "limits" / f"{workload}.json").read_text())

    def mine(m):
        return m.get("workloads") is None or workload in m["workloads"]

    e2e = [m for m in bench["end_to_end"] if mine(m)]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if mine(m) and m["moves"] in reported]
    cell = Cell(workload, cfg, traffic, limits, e2e, layer, int(seed), float(seconds),
                bool(trace), torch.device(device))
    if t_start is not None:
        cell.t_start = t_start
    return cell


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def dtype_of(cfg: dict) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float16": torch.float16,
            "float32": torch.float32}[cfg["dtype"]]


def port_task(cfg: dict, params: Dict[str, torch.Tensor], device):
    """The program's task with its model holding ``params``."""
    from tpu_mednet_torch.models import ResidualUNet3D
    from tpu_mednet_torch.tasks import LandmarkTask, SegmentationTask

    model = ResidualUNet3D(int(cfg["in_channels"]), int(cfg["out_channels"]),
                           f_maps=int(cfg["f_maps"]), conv_layer_order=cfg["layer_order"],
                           num_groups=int(cfg["num_groups"]), dtype=dtype_of(cfg),
                           num_levels=int(cfg["num_levels"]), device=device)
    model.load_state_dict(params, strict=True)
    if cfg["task"] == "landmarks":
        return LandmarkTask(model=model, loss_regression_weight=cfg["loss_regression_weight"],
                            loss_class=cfg["loss_class"],
                            loss_class_weight=cfg["loss_class_weight"],
                            loss_regression=cfg["loss_regression"])
    return SegmentationTask(model=model, loss=cfg["loss"], loss_weight=cfg.get("loss_weight"))


def k1_launches() -> int:
    from tpu_mednet_torch.ops import groupnorm

    return groupnorm.STATS_LAUNCHES


def reader(name: str):
    """``metrics/<name>.py``, else the module of the name's part before its
    first dot."""
    for stem in (name, name.split(".")[0]):
        path = HERE / "metrics" / f"{stem}.py"
        if path.exists():
            spec = importlib.util.spec_from_file_location(f"h100bench_metric_{stem}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod.read
    raise FileNotFoundError(f"no reader for metric {name!r} under {HERE / 'metrics'}")


NOT_A_NUMBER = 1e30  # a reading that is no finite number fails any limit


def judge(checks: Dict[str, float], limits: dict) -> Dict[str, dict]:
    """Each number compared, the cell's limit file naming it, beside its
    limit; the loops' other readings are not compared (PERF.md says why)."""
    return {k: {"value": checks[k] if math.isfinite(checks[k]) else NOT_A_NUMBER,
                "limit": limit} for k, limit in limits.items()}


def execute(cell: Cell) -> dict:
    """The cell's run after the look for a chip: its result line as a dict."""
    loop = importlib.import_module(f"h100bench.loops.{cell.traffic['loop']}")
    record = loop.run(cell)
    metrics = {}
    for m in (cell.per_layer if cell.trace else cell.end_to_end):
        value = reader(m["name"])(record)
        if value is not None and math.isfinite(value):
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    checks = judge(record["checks"], cell.limits)
    correct = all(c["value"] <= c["limit"] for c in checks.values()) and not record["failed"]
    device = {"platform": "gpu" if cell.device.type == "cuda" else cell.device.type,
              "kind": (torch.cuda.get_device_name(cell.device) if cell.device.type == "cuda"
                       else "cpu"),
              "count": 1, "memory_peak_bytes": int(record["memory_peak_bytes"])}
    out = {"correct": bool(correct), "attempted": int(record["attempted"]),
           "failed": int(record["failed"]), "metrics": metrics, "device": device}
    stretch = record.get("stretch")
    if cell.trace and stretch is not None:
        device["busy_s"] = stretch["busy_s"]
        device["window_s"] = stretch["wall_s"]
        out["breakdown"] = {"device_ops": [list(kv) for kv in stretch["device_ops"]],
                            "idle_gaps": [list(kv) for kv in stretch["idle_gaps"]]}
    out["checks"] = checks
    return out


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
