"""Inspect a checkpoint directory of the port:
``python -m tpu_mednet_torch.cli.inspect_ckpt``.

The port's copy of ``tpu_mednet/cli/inspect_ckpt.py`` (the reference's PL
``.ckpt`` files are opaque pickles; here the hparams side-car makes a
checkpoint describe itself)::

    python -m tpu_mednet_torch.cli.inspect_ckpt --checkpoint runs/model
    python -m tpu_mednet_torch.cli.inspect_ckpt --checkpoint runs/model --json

Reports the retained steps, the best-val checkpoint (monitored metric,
value and step), the detected task, the architecture and its parameter
count (from a model built on the ``meta`` device: no weights are read or
allocated), the optimizer and schedule, EMA, and the checkpoint format.
It reads side-cars only, on the host.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
import types
from pathlib import Path
from typing import Optional, Sequence

from tpu_mednet_torch.config import load_dotenv, replace_env

logger = logging.getLogger("inspect")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--checkpoint", required=True,
                        help="checkpoint directory of the port")
    parser.add_argument("--json", action="store_true",
                        help="emit one JSON object instead of text")
    parser.add_argument("--log_level", type=str, default="WARNING")
    return parser


def inspect_checkpoint(ckpt_dir) -> dict:
    """Collect the checkpoint's self-description as a plain dict."""
    from tpu_mednet_torch.cli.predict import _coerce
    from tpu_mednet_torch.inference.serving import detect_task_name
    from tpu_mednet_torch.tasks import LandmarkTask, SegmentationTask
    from tpu_mednet_torch.train.checkpoint import CheckpointManager

    ckpt_dir = Path(replace_env(str(ckpt_dir)))
    mgr = CheckpointManager(ckpt_dir)
    steps = mgr.available_steps
    hp = mgr.restore_hparams() if steps else None

    info: dict = {
        "checkpoint": str(ckpt_dir),
        "steps": steps,
        "latest_step": steps[-1] if steps else None,
        "ckpt_format": (hp or {}).get("ckpt_format"),
    }

    if hp:
        task_name = detect_task_name(hp)
        info["task"] = task_name
        ns = types.SimpleNamespace(**{k: _coerce(v) for k, v in hp.items()})
        try:
            task = (LandmarkTask if task_name == "LandmarkNet"
                    else SegmentationTask).from_hparams(ns, device="meta")
            cfg = task.model.config
            widths = ({"arch": "SwinUNETR", "feature_size": cfg.feature_size}
                      if hasattr(cfg, "feature_size") else
                      {"f_maps": list(cfg.feature_maps), "levels": len(cfg.feature_maps),
                       "block": cfg.block, "layer_order": cfg.layer_order})
            info["model"] = {
                "in_channels": cfg.in_channels,
                "out_channels": cfg.out_channels,
                **widths,
                "dtype": str(cfg.dtype).removeprefix("torch."),
                # a TPU layout the port has not; reported as the run set it
                "packed": bool(getattr(ns, "packed", False)),
                "params": sum(p.numel() for p in task.model.parameters()),
            }
        except Exception as e:  # stay usable on foreign/partial side-cars
            info["model"] = {"error": f"could not rebuild model: {e}"}
        opt_keys = ("optimizer", "learning_rate", "lr_schedule",
                    "warmup_steps", "weight_decay", "grad_clip_norm",
                    "accumulate_grad_batches", "ema_decay")
        info["optimizer"] = {k: hp[k] for k in opt_keys
                             if hp.get(k) not in (None, "")}
        info["ema"] = bool(float(hp.get("ema_decay") or 0.0) > 0.0)

    best_dir = ckpt_dir / "best"
    if best_dir.is_dir():
        bmgr = CheckpointManager(best_dir)
        bhp = bmgr.restore_hparams() if bmgr.available_steps else None
        monitor = (bhp or {}).get("_best_monitor") or {}
        if monitor:
            info["best"] = monitor
    return info


def _print_text(info: dict) -> None:
    print(f"checkpoint : {info['checkpoint']}")
    print(f"steps      : {info['steps']} (latest: {info['latest_step']})")
    print(f"ckpt_format: {info.get('ckpt_format')}")
    if "task" in info:
        print(f"task       : {info['task']}")
    model = info.get("model")
    if model and "error" not in model:
        shape = ("Swin UNETR, feature_size={feature_size}" if "feature_size" in model else
                 "{block} U-Net, f_maps={f_maps} ({levels} levels)")
        order = "" if "feature_size" in model else ", order={layer_order}"
        print(("model      : " + shape + ", in={in_channels} out={out_channels}" + order
               + ", dtype={dtype}, packed={packed}").format(**model))
        print(f"params     : {model['params'] / 1e6:.2f}M "
              f"({model['params']:,})")
    elif model:
        print(f"model      : {model['error']}")
    if info.get("optimizer"):
        opts = ", ".join(f"{k}={v}" for k, v in info["optimizer"].items())
        print(f"optimizer  : {opts}")
    if "ema" in info:
        print(f"ema        : {info['ema']}")
    best = info.get("best")
    if best:
        print(f"best       : {best.get('metric')}={best.get('value'):.6g} "
              f"at step {best.get('step')}")


def main(argv: Optional[Sequence[str]] = None) -> int:
    load_dotenv()
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=args.log_level)

    info = inspect_checkpoint(args.checkpoint)
    if args.json:
        print(json.dumps(info, default=str))
    else:
        _print_text(info)
    return 0


if __name__ == "__main__":
    sys.exit(main())
