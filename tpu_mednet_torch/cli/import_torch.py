"""Import a reference (midasmednet) checkpoint:
``python -m tpu_mednet_torch.cli.import_torch``.

The port's copy of ``tpu_mednet/cli/import_torch.py``.  It turns a
pytorch-lightning checkpoint trained with the reference framework
(``examples/train_seg.py:122-131``'s default checkpointing), or a bare
``torch.save(model.state_dict())`` file, into a checkpoint directory of
the port with the hparams side-car, so ``predict`` and ``--resume`` take
it as they take a training run's::

    python -m tpu_mednet_torch.cli.import_torch --checkpoint epoch=42.ckpt \\
        --output runs/imported
    python -m tpu_mednet_torch.cli.predict -c predict.yaml \\
        prediction.checkpoint=runs/imported

The weights keep their names and layouts (``utils/torch_import.py``).
The architecture is held against the shapes of the weights themselves,
so a wrong or missing hparams bundle cannot import a mis-shaped model;
the directory holds a fresh train state (Adam) at the ``.ckpt``'s
``global_step``.  It runs on the host: the model is built on the ``meta``
device, checked, and takes the loaded CPU tensors as its parameters.
"""

from __future__ import annotations

import argparse
import logging
import sys
import types
from typing import Optional, Sequence

from tpu_mednet_torch.config import load_dotenv, replace_env

logger = logging.getLogger("import_torch")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--checkpoint", required=True,
                        help="reference .ckpt (pytorch-lightning) or a bare "
                             "torch state_dict file")
    parser.add_argument("--output", required=True,
                        help="output checkpoint directory")
    parser.add_argument("--model", default=None,
                        choices=["SegmentationNet", "LandmarkNet"],
                        help="default: auto-detect (landmark checkpoints "
                             "carry loss_regression_weight in hparams)")
    parser.add_argument("--set", dest="overrides", nargs="*", default=[],
                        metavar="KEY=VALUE",
                        help="hparams overrides/additions, e.g. "
                             "loss_regression_weight=0.001,0.015 for a bare "
                             "state_dict with no hparams bundle")
    parser.add_argument("--log_level", type=str, default="INFO")
    return parser


def _parse_override(kv: str):
    if "=" not in kv:
        raise SystemExit(f"--set expects KEY=VALUE, got {kv!r}")
    k, v = kv.split("=", 1)
    from tpu_mednet_torch.cli.predict import _coerce

    if "," in v:
        return k, [_coerce(x) for x in v.split(",")]
    return k, _coerce(v)


def main(argv: Optional[Sequence[str]] = None) -> int:
    load_dotenv()
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=args.log_level)

    import torch

    from tpu_mednet_torch.cli.predict import _coerce
    from tpu_mednet_torch.inference.serving import detect_task_name
    from tpu_mednet_torch.tasks import LandmarkTask, SegmentationTask
    from tpu_mednet_torch.train import CheckpointManager, create_train_state
    from tpu_mednet_torch.utils.torch_import import (
        check_against_template,
        infer_architecture,
        load_torch_checkpoint,
    )

    ckpt_path = replace_env(args.checkpoint)
    sd, hparams, step = load_torch_checkpoint(ckpt_path)
    arch = infer_architecture(sd)
    logger.info(
        "loaded %s: %s family, in=%d out=%d f_maps=%s, global_step=%d, "
        "hparams %s", ckpt_path, arch["family"], arch["in_channels"],
        arch["out_channels"], arch["f_maps"], step,
        "present" if hparams else "absent",
    )
    if arch["family"] != "residual":
        raise SystemExit(
            "the checkpoint is a vanilla (DoubleConv) UNet3D — the reference "
            "tasks train ResidualUNet3D only (segmentation.py:22, "
            "landmarks.py:22), so there is no task to attach it to. Use "
            "tpu_mednet.utils.torch_import.convert_state_dict for "
            "programmatic access to the converted weights."
        )

    hparams = dict(hparams or {})
    for kv in args.overrides:
        k, v = _parse_override(kv)
        hparams[k] = v

    # reconcile hparams with shapes inferred from the weights themselves
    for key, inferred in (
        ("in_channels", arch["in_channels"]),
        ("out_channels", arch["out_channels"]),
    ):
        got = _coerce(hparams.get(key)) if key in hparams else None
        if got is not None and int(got) != inferred:
            raise SystemExit(
                f"hparams say {key}={got} but the weights have "
                f"{key}={inferred}; refusing to import a mis-shaped model"
            )
        hparams[key] = inferred
    if "fmaps" in hparams:
        fm = _coerce(hparams["fmaps"])
        expanded = (
            tuple(int(fm) * 2**k for k in range(arch["num_levels"]))
            if isinstance(fm, (int, float))
            else tuple(int(x) for x in fm)
        )
        if expanded != arch["f_maps"]:
            raise SystemExit(
                f"hparams fmaps={fm} expands to {expanded} but the weights "
                f"have f_maps={arch['f_maps']}; refusing to import"
            )
    # store the explicit per-level list: it carries the depth too (the
    # reference expands an int fmaps to 5 levels, model.py:148-150)
    hparams["fmaps"] = list(arch["f_maps"])
    hparams.setdefault("learning_rate", 1e-3)

    ns = types.SimpleNamespace(**{k: _coerce(v) for k, v in hparams.items()})
    detected = detect_task_name(hparams)
    model_name = args.model
    if model_name is None:
        model_name = detected
        logger.info("--model not set; detected %s from hparams", model_name)
    elif model_name != detected:
        raise SystemExit(
            f"--model {model_name} but the hparams say the checkpoint was "
            f"trained as {detected} (loss_regression_weight "
            f"{'present' if detected == 'LandmarkNet' else 'absent'}); "
            "fix --model, or --set/remove loss_regression_weight"
        )
    if model_name == "LandmarkNet":
        if not getattr(ns, "loss_regression_weight", None):
            raise SystemExit(
                "LandmarkNet import needs loss_regression_weight (defines "
                "the heatmap/class channel split, landmarks.py:57); pass "
                "--set loss_regression_weight=w1,w2,..."
            )
        task = LandmarkTask.from_hparams(ns, device="meta")
    else:
        task = SegmentationTask.from_hparams(ns, device="meta")

    model = task.model
    check_against_template(sd, model.state_dict())
    # the meta model takes the loaded tensors as its (fp32) parameters
    model.load_state_dict({k: v.to(torch.float32) for k, v in sd.items()},
                          strict=True, assign=True)
    state = create_train_state(model, learning_rate=float(getattr(ns, "learning_rate", 1e-3)))
    # the torch run's global_step goes INTO the state too, so --resume
    # continues its epoch accounting (not just the directory's name)
    state.step = step

    CheckpointManager(replace_env(args.output)).save(step, state, hparams=hparams)
    n_params = sum(p.numel() for p in model.parameters())
    logger.info(
        "imported %s (%s params) at step %d -> %s",
        model_name, f"{n_params:,}", step, args.output,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
