"""The readings a cell's correctness limits are set from (not run by a benchmark run).

    python3 h100bench/control.py --workload <cell> --seeds <n> [<n> ...]
        [--control-seeds k] [--serve-seconds s] [--out chiprun_out/control_<cell>.json]

For every seed, in one process: the sound reading, the program's numbers
against the reference's, as a run of the cell compares them (training:
set-up and the first steps, with no window; serving: a short window at the
cell's own load).  For the first ``--control-seeds`` seeds also the
control, the cell's family's reference with every convolution's and
matrix product's operands rounded through float8 e4m3 (the precision
below the configured bf16) in the program's place, and, for training, the
half-batch fault planted in the reference (its loss over the first half
of each batch only) and the state left unchanged (no run: the program's
norms read 0).  Prints one JSON line a
seed and reading, then, per number, the largest sound reading and the
least control and fault readings; writes them all to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--serve-seconds", type=float, default=6.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    import torch

    from h100bench import data, harness
    from h100bench.loops import serve, train
    from h100bench.reference import serve as ref_serve
    from h100bench.reference import train as ref_train
    from h100bench.reference.precision import fp8_round

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    rows = []
    for i, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        cell = harness.load_cell(args.workload, seed, 0.0, False, "cuda:0")
        kind = cell.traffic["loop"]
        if kind == "serve":
            cell.seconds = args.serve_seconds
        record = (train if kind == "train" else serve).run(cell)
        rows.append({"seed": seed, "reading": "sound", **record["checks"]})
        print(json.dumps(rows[-1]), flush=True)
        if kind == "train":
            rows[-1]["leaves"] = record["readings"]
            print(json.dumps({"seed": seed, "worst": _worst(ref_train, record["readings"])}),
                  flush=True)
        if i < args.control_seeds:
            if kind == "train":
                store = data.training_subjects(cell.traffic, _classes(cell.cfg), seed, cell.device)
                ref = record["readings"]["reference"]
                for name, kw in (("control_fp8", {"quant": fp8_round}),
                                 ("fault_half_batch", {"half_batch": True})):
                    got = train.reference_readings(cell, store, **kw)
                    rows.append({"seed": seed, "reading": name, **ref_train.compare(got, ref)})
                    print(json.dumps(rows[-1]), flush=True)
                    rows[-1]["leaves"] = {"program": got, "reference": ref}
                rows.append({"seed": seed, "reading": "fault_unchanged",
                             **ref_train.compare(ref_train.unchanged(ref), ref)})
                print(json.dumps(rows[-1]), flush=True)
            else:
                t, cfg, fam = cell.traffic, cell.cfg, cell.family
                pool = data.serving_pool(t, seed, cell.device)
                params = data.weights(fam, cfg, seed, cell.device)
                gap = max(ref_serve.control_gap(fam, cfg, params, pool[k], t["patch"],
                                                t["overlap"], int(t["reference_rows"]),
                                                cell.device, fp8_round)
                          for k in record["judged"])
                rows.append({"seed": seed, "reading": "control_fp8", "logit_gap": gap})
                print(json.dumps(rows[-1]), flush=True)
        torch.cuda.empty_cache()
        print(f"seed {seed}: {time.perf_counter() - t0:.1f} s", file=sys.stderr, flush=True)
    summary = {}
    for r in rows:
        for k, v in r.items():
            if k in ("seed", "reading", "leaves"):
                continue
            s = summary.setdefault(k, {})
            if r["reading"] == "sound":
                s["lower"] = max(s.get("lower", 0.0), v)
            else:
                s[r["reading"]] = min(s.get(r["reading"], float("inf")), v)
    print(json.dumps({"workload": args.workload, "summary": summary}), flush=True)
    out = Path(args.out or ROOT / "chiprun_out" / f"control_{args.workload}.json")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"workload": args.workload, "rows": rows, "summary": summary},
                              indent=1))
    return 0


def _worst(ref_train, readings: dict, n: int = 4) -> dict:
    """The leaves that read the largest gaps, each with its gap and the
    reference's and the program's norms: where a number comes from."""
    got, want = readings["program"], readings["reference"]
    keep = ref_train.kept_leaves(want)
    out = {}
    for norm in ("grad_norms", "change_norms"):
        gaps = ref_train.leaf_gaps(got[norm], want[norm], keep)
        worst = sorted(gaps, key=gaps.get, reverse=True)[:n]
        out[norm] = [(k, gaps[k], want[norm][k], got[norm][k]) for k in worst]
    out["losses"] = [got["losses"], want["losses"]]
    return out


def _classes(cfg: dict) -> int:
    return int(cfg["out_channels"]) - len(cfg.get("loss_regression_weight") or [])


if __name__ == "__main__":
    sys.exit(main())
