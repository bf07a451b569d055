"""One run of one cell: find its files by name, drive its loop, judge and report.

A cell of ``BENCHMARK.json`` names a configuration (its file, a JSON object
of the model's sizes and the task's loss and optimizer, whose ``model``
names its family: ``families/<model>.py``, the program's task, the
seeded weights, the reference and the counts) and a traffic mix
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
import types
from pathlib import Path
from typing import Dict, Optional, Sequence

import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_mednet")

FAMILIES = HERE / "families"


def check_keys(cfg: dict, where: str, implemented: dict, optional: Sequence[str],
               family: str) -> None:
    """Refuse a configuration naming a value of a key that ``family`` does
    not implement (``implemented``: key -> the values it does; a key of
    ``optional`` is checked only where the configuration has it): it would
    otherwise be measured, and judged, as this family."""
    for key, known in implemented.items():
        if key in optional and key not in cfg:
            continue
        if cfg.get(key) not in known:
            raise SystemExit(f"{where}: {key} {cfg.get(key)!r} is not implemented by "
                             f"h100bench's {family} family (it implements {', '.join(known)})")


def family_of(cfg: dict, where: str, families: Path = FAMILIES) -> types.ModuleType:
    """The module ``<families>/<model>.py`` of the configuration's ``model``,
    which has checked the configuration.  A family module gives, each a
    function of the configuration:

    - ``check(cfg, where)``: refuses the keys it does not implement;
    - ``port_task(cfg, params, device)``: the program's task, its model
      holding ``params``; ``optimizer(cfg)``: the fields of the program's
      ``OptimizerConfig`` for the training loop;
    - ``param_count(cfg)`` and ``init_from_uniform(cfg, u)``: the fp32
      parameters, keyed by the published state-dict names, from one flat
      U[0, 1) draw of that many floats (``data.weights``);
    - the plain fp32 reference, importing nothing of the program:
      ``forward(cfg, params, x, quant)`` (``quant`` applied to every
      convolution's and matrix product's operands, for the control),
      ``reference_loss(cfg)`` (its ``terms``, ``value`` and ``linearised``:
      ``reference.train.Loss`` serves Dice and L2) and
      ``reference_update(cfg, params, grads, m, v, step)``
      (``reference.train.adam_`` serves Adam and AdamW);
    - counts of one sample: ``forward_flops(cfg, patch)`` (every conv and
      matmul FLOP, MFU's numerator), ``conv_flops(cfg, patch)``
      (``conv_roofline``'s), ``norm_layers(cfg, patch)`` (K1's bytes);
    - ``KERNEL_GROUPS``: name part -> a group of its own, which
      ``trace.group_of`` checks before the shared rule, and
      ``group_work(cfg, patch, train)``: each such group's work
      (``{"flops": ..., "bytes": ...}``) a sample of a train step
      (``train``) or a served tile, which the loops store in the
      stretch's ``work`` scaled by the samples it ran.
    """
    path = Path(families) / f"{cfg.get('model')}.py"
    if not path.is_file():
        raise SystemExit(f"{where}: model {cfg.get('model')!r} has no family module: "
                         f"{path} not found")
    mod = _load(path, f"h100bench_family_{path.stem}")
    mod.check(cfg, where)
    return mod


def _load(path: Path, name: str) -> types.ModuleType:
    """The module of the file ``path``, found by file and not by package."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


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
    family: types.ModuleType         # the configuration's module under families/
    fault: Optional[str] = None      # a planted fault (tests of the comparison only)
    t_start: float = dataclasses.field(default_factory=time.perf_counter)


def load_cell(workload: str, seed: int, seconds: float, trace: bool, device,
              bench: Optional[dict] = None, t_start: Optional[float] = None,
              families: Path = FAMILIES) -> Cell:
    bench = bench or json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    cfg = json.loads((ROOT / conf["file"]).read_text())
    family = family_of(cfg, conf["file"], families)
    traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())
    limits = json.loads((HERE / "limits" / f"{workload}.json").read_text())

    def mine(m):
        return m.get("workloads") is None or workload in m["workloads"]

    e2e = [m for m in bench["end_to_end"] if mine(m)]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if mine(m) and m["moves"] in reported]
    cell = Cell(workload, cfg, traffic, limits, e2e, layer, int(seed), float(seconds),
                bool(trace), torch.device(device), family)
    if t_start is not None:
        cell.t_start = t_start
    return cell


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def k1_launches() -> int:
    from tpu_mednet_torch.ops import groupnorm

    return groupnorm.STATS_LAUNCHES


def reader(name: str):
    """``metrics/<name>.py``, else the module of the name's part before its
    first dot."""
    for stem in (name, name.split(".")[0]):
        path = HERE / "metrics" / f"{stem}.py"
        if path.exists():
            return _load(path, f"h100bench_metric_{stem}").read
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
