"""Config and flags: a YAML config file, CLI overrides and env paths.

The port's own copy of ``tpu_mednet/config.py`` (the port imports nothing
of the JAX package), with the same user-facing semantics:

- ``-c cfg.yaml`` loads defaults from YAML; explicit CLI flags win;
- ``$DATA`` / ``$MODEL`` (and any ``$VAR``) in path-typed values expand from
  the environment, seeded from a ``.env`` file when present;
- the prediction CLI reads the grouped layout (``base.*`` /
  ``prediction.*``) with dotted ``key=value`` overrides.
"""

from __future__ import annotations

import argparse
import logging
import os
import re
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

import yaml

logger = logging.getLogger(__name__)


def load_dotenv(path: str = ".env") -> None:
    """Minimal .env loader (KEY=VALUE lines; no override of existing env)."""
    p = Path(path)
    if not p.exists():
        return
    for line in p.read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#") or "=" not in line:
            continue
        key, _, value = line.partition("=")
        os.environ.setdefault(key.strip(), value.strip().strip("'\""))


_VAR_RE = re.compile(r"\$(\w+)|\$\{(\w+)\}")


def replace_env(value: str) -> str:
    """Expand ``$VAR``/``${VAR}`` from the environment (chained correctly)."""
    def sub(m):
        name = m.group(1) or m.group(2)
        return os.environ.get(name, m.group(0))
    return _VAR_RE.sub(sub, str(value))


def env_path(value: str) -> str:
    return replace_env(value)


def parse_remat(value):
    """'0'/'false' -> False, 'all'/'true' -> True, 'k' -> int k."""
    if isinstance(value, bool):
        return value
    v = str(value).lower()
    if v in ("0", "false", "none", ""):
        return False
    if v in ("all", "true"):
        return True
    return int(v)


# -- YAML ---------------------------------------------------------------------

def load_yaml_file(path):
    with open(replace_env(str(path))) as f:
        return yaml.safe_load(f)


# -- argument groups ------------------------------------------------------------

def add_common_train_args(parser: argparse.ArgumentParser) -> None:
    """Experiment-level flags (reference train_seg.py:34-56)."""
    parser.add_argument("-c", "--config", type=str, default=None,
                        help="YAML config file (values become defaults)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--neptune_project", type=str, default=None,
                        help="Neptune project; logs there when NEPTUNE_API_TOKEN is "
                             "set and the neptune client imports")
    parser.add_argument("--experiment_name", type=str, default="experiment")
    parser.add_argument("--data_path", type=env_path)
    parser.add_argument("--image_group", type=str, default="images")
    parser.add_argument("--label_group", type=str, default="labels")
    parser.add_argument("--train_set", type=env_path)
    parser.add_argument("--val_set", type=env_path)
    parser.add_argument("--model_dir", type=env_path)
    parser.add_argument("--log_dir", type=env_path)
    parser.add_argument("--patch_size", type=int, nargs="+", default=[96, 96, 96])
    parser.add_argument("--class_probabilities", type=float, nargs="+", default=None)
    parser.add_argument("--patches_per_subject", type=int, default=10)
    parser.add_argument("--data_augmentation", action="store_true")
    parser.add_argument("--aug_mirror", action="store_true",
                        help="add random mirror flips on all spatial axes "
                             "to the augmentation pipeline")
    parser.add_argument("--aug_noise_sigma", type=float, default=0.0,
                        help="additive gaussian noise sigma (0 = off)")
    parser.add_argument("--aug_elastic_sigma", type=float, default=0.0,
                        help="on-device elastic deformation: coarse-grid "
                             "displacement sigma in voxels (0 = off)")
    parser.add_argument("--aug_elastic_grid", type=int, default=4,
                        help="elastic deformation control grid size")
    parser.add_argument("--aug_rotate_deg", type=float, default=0.0,
                        help="random 3D rotation, max degrees per axis "
                             "(0 = off)")
    parser.add_argument("--aug_scale", type=float, nargs=2, default=None,
                        metavar=("LO", "HI"),
                        help="random isotropic scale range, e.g. 0.85 1.25")
    parser.add_argument("--aug_spatial_prob", type=float, default=1.0,
                        help="per-sample probability of the elastic/rotate/"
                             "scale transform")
    parser.add_argument("--gpus", type=int, default=1,
                        help="data-parallel ranks, one a GPU (clamped to those "
                             "visible; with --device cpu, gloo ranks)")
    parser.add_argument("--preload", action="store_true")
    parser.add_argument("--resume", type=str, default=None)
    parser.add_argument("--max_epochs", type=int, default=100)
    parser.add_argument("--log_level", type=str, default="INFO")
    parser.add_argument("--packed", action="store_true", default=True,
                        help="accepted for parity with the JAX package's flags; "
                             "the port has no z-packed layout and ignores it")
    parser.add_argument("--no_packed", dest="packed", action="store_false")
    parser.add_argument("--remat", type=str, default="0",
                        help="rematerialization: 0=off, all=every stage, "
                             "k=recompute the k highest-resolution stages in "
                             "the backward")
    parser.add_argument("--device_sampler", action="store_true",
                        help="keep volumes resident on the card and gather "
                             "patches there (DevicePatchSampler)")
    parser.add_argument("--spatial_shards", type=int, default=1,
                        help="partition the patch X axis over this many "
                             "devices per data-parallel replica (the mesh's "
                             "'space' axis: spatially partitioned training "
                             "with halo exchange) — for patches too large "
                             "for one card")
    parser.add_argument("--native_loader", dest="native_loader",
                        action="store_true", default=None,
                        help="require the native (C++) batch pipeline "
                             "(tpu_mednet_torch/native); default: auto-enable "
                             "when available — batches are byte-identical "
                             "to the numpy path")
    parser.add_argument("--no_native_loader", dest="native_loader",
                        action="store_false",
                        help="force the numpy batch pipeline")
    parser.add_argument("--bf16", action="store_true", default=True)
    parser.add_argument("--no_bf16", dest="bf16", action="store_false")
    add_optimizer_args(parser)
    add_runtime_control_args(parser)


def augment_config_from_hparams(hparams):
    """The on-device ``AugmentConfig`` from CLI flags, or None.

    ``--data_augmentation`` alone reproduces the reference Compose
    (brightness/gamma/contrast, train_seg.py:84-86); the ``--aug_*`` flags
    extend it with mirror flips, noise and the spatial transform, and any of
    them implies augmentation.
    """
    from tpu_mednet_torch.ops.augment import AugmentConfig

    spatial = (hparams.aug_elastic_sigma or hparams.aug_rotate_deg
               or hparams.aug_scale is not None)
    if not (hparams.data_augmentation or hparams.aug_mirror
            or hparams.aug_noise_sigma or spatial):
        return None
    return AugmentConfig(
        mirror_axes=(1, 2, 3) if hparams.aug_mirror else (),
        noise_sigma=hparams.aug_noise_sigma,
        elastic_sigma=hparams.aug_elastic_sigma,
        elastic_grid=hparams.aug_elastic_grid,
        rotate_deg=hparams.aug_rotate_deg,
        scale_range=tuple(hparams.aug_scale) if hparams.aug_scale else None,
        spatial_prob=hparams.aug_spatial_prob,
    )


def add_runtime_control_args(parser: argparse.ArgumentParser) -> None:
    """PL Trainer runtime knobs (reference train_seg.py:122-132 gets these
    from ``pl.Trainer``): val frequency, early stopping, epoch limits."""
    parser.add_argument("--check_val_every_n_epoch", type=int, default=1,
                        help="run validation every N epochs (PL Trainer arg)")
    parser.add_argument("--early_stop_patience", type=int, default=0,
                        help="stop after N val checks without val_loss "
                             "improving by > --early_stop_min_delta "
                             "(PL EarlyStopping; 0 = off)")
    parser.add_argument("--early_stop_min_delta", type=float, default=0.0)
    parser.add_argument("--limit_train_batches", type=int, default=0,
                        help="cap train batches per epoch (0 = full epoch)")
    parser.add_argument("--limit_val_batches", type=int, default=0,
                        help="cap val batches per epoch (0 = all)")
    parser.add_argument("--keep_checkpoints", type=int, default=3,
                        help="resumable checkpoints to retain in model_dir "
                             "(the best-val checkpoint is kept separately)")
    parser.add_argument("--track_grad_norm", action="store_true",
                        help="log the pre-clip global gradient L2 norm "
                             "as 'grad_norm' (PL track_grad_norm=2)")
    parser.add_argument("--nonfinite", choices=["off", "skip", "terminate"],
                        default="off",
                        help="NaN/Inf protection: 'skip' leaves the parameters "
                             "untouched on a step whose loss or gradient is "
                             "non-finite (one host read of a device flag per "
                             "step) and logs the per-epoch skip count; "
                             "'terminate' also checkpoints and stops")


def add_optimizer_args(parser: argparse.ArgumentParser) -> None:
    """Optimizer/schedule flags (``train/optim.py`` ``OptimizerConfig``).

    Defaults reproduce the reference's plain ``Adam(lr)``
    (segmentation.py:119-120).
    """
    parser.add_argument("--optimizer", choices=["adam", "adamw", "sgd"],
                        default="adam")
    parser.add_argument("--weight_decay", type=float, default=0.0,
                        help="decoupled weight decay (adamw) or coupled "
                             "L2 (sgd)")
    parser.add_argument("--beta1", type=float, default=0.9)
    parser.add_argument("--beta2", type=float, default=0.999)
    parser.add_argument("--adam_eps", dest="eps", type=float, default=1e-8)
    parser.add_argument("--momentum", type=float, default=0.9,
                        help="sgd momentum")
    parser.add_argument("--nesterov", action="store_true")
    parser.add_argument("--grad_clip_norm", type=float, default=0.0,
                        help="clip gradients by global norm (0 = off)")
    parser.add_argument("--lr_schedule",
                        choices=["constant", "cosine", "linear", "poly",
                                 "step", "plateau"],
                        default="constant")
    parser.add_argument("--warmup_steps", type=int, default=0,
                        help="linear LR warmup from 0 over this many steps")
    parser.add_argument("--total_steps", type=int, default=0,
                        help="schedule horizon; 0 = steps_per_epoch * "
                             "max_epochs")
    parser.add_argument("--end_lr_factor", type=float, default=0.0,
                        help="final lr = learning_rate * factor "
                             "(cosine/linear/poly)")
    parser.add_argument("--poly_power", type=float, default=0.9)
    parser.add_argument("--lr_decay_every", type=int, default=0,
                        help="step schedule: decay every N steps")
    parser.add_argument("--lr_decay_rate", type=float, default=0.1,
                        help="step schedule: multiply lr by this each decay")
    parser.add_argument("--lr_plateau_factor", type=float, default=0.1,
                        help="plateau schedule: multiply lr by this after "
                             "--lr_plateau_patience stale val checks "
                             "(torch ReduceLROnPlateau semantics)")
    parser.add_argument("--lr_plateau_patience", type=int, default=10)
    parser.add_argument("--lr_plateau_min_delta", type=float, default=0.0)
    parser.add_argument("--min_lr", type=float, default=0.0,
                        help="plateau schedule: LR floor")
    parser.add_argument("--accumulate_grad_batches", type=int, default=1,
                        help="apply the optimizer every k micro-batches on "
                             "the averaged gradient (PL "
                             "accumulate_grad_batches)")
    parser.add_argument("--ema_decay", type=float, default=0.0,
                        help="exponential moving average of the weights "
                             "(e.g. 0.999): validation, the best-checkpoint "
                             "choice and inference use the EMA weights "
                             "(0 = off)")


def add_seg_model_args(parser: argparse.ArgumentParser) -> None:
    """SegmentationNet model flags (segmentation.py:43-53 hparams surface)."""
    parser.add_argument("--learning_rate", type=float, default=0.001)
    parser.add_argument("--fmaps", type=int, default=64)
    parser.add_argument("--batch_size", type=int, default=4)
    parser.add_argument("--num_workers", type=int, default=4,
                        help="accepted for reference parity; one prefetch "
                             "thread replaces the worker pool")
    parser.add_argument("--in_channels", type=int, default=1)
    parser.add_argument("--out_channels", type=int, default=1)
    parser.add_argument("--log_interval", type=int, default=5)
    parser.add_argument("--log_vis_mip", type=str, choices=["mean", "max"],
                        default="mean",
                        help="projection of the MIP sample figures logged every "
                             "--log_interval-th validation batch (needs matplotlib)")
    parser.add_argument("--loss", choices=["DICE", "CE", "DICE_CE"], default="DICE")
    parser.add_argument("--loss_weight", nargs="+", type=float, default=None)
    # the port's own: absent from the namespace unless given (flag or -c
    # config), so a parse without them equals the JAX package's
    parser.add_argument("--arch", choices=["ResidualUNet3D", "SwinUNETR"],
                        default=argparse.SUPPRESS,
                        help="model: ResidualUNet3D (the default) or SwinUNETR (v1)")
    parser.add_argument("--feature_size", type=int, default=argparse.SUPPRESS,
                        help="SwinUNETR's embedding width (default 48)")


def add_landmark_model_args(parser: argparse.ArgumentParser) -> None:
    """LandmarkNet model flags (landmarks.py:191-206, same defaults)."""
    parser.add_argument("--learning_rate", type=float, default=0.001)
    parser.add_argument("--fmaps", type=int, default=64)
    parser.add_argument("--batch_size", type=int, default=4)
    parser.add_argument("--num_workers", type=int, default=4,
                        help="accepted for reference parity; one prefetch "
                             "thread replaces the worker pool")
    parser.add_argument("--in_channels", type=int, default=1)
    parser.add_argument("--out_channels", type=int, default=1)
    parser.add_argument("--log_interval", type=int, default=5)
    parser.add_argument("--log_vis_mip", type=str, choices=["mean", "max"],
                        default="mean",
                        help="projection of the MIP sample figures logged every "
                             "--log_interval-th validation batch (needs matplotlib)")
    parser.add_argument("--heatmap_group", type=str, default="heatmaps")
    parser.add_argument("--landmark_group", type=str, default=None,
                        help="group of per-subject (L,3) landmark coords; "
                             "heatmaps are rendered on the device instead of "
                             "loading stored heatmap volumes (requires "
                             "--device_sampler)")
    parser.add_argument("--heatmap_sigma", type=float, default=4.0)
    parser.add_argument("--loss_class", choices=["DICE", "CE"], default="DICE")
    parser.add_argument("--loss_class_weight", nargs="+", type=float,
                        default=[0.05, 1.0])
    parser.add_argument("--loss_regression", choices=["L2", "L1"], default="L2")
    parser.add_argument("--loss_regression_weight", type=float, nargs="+",
                        default=[0.001, 0.015, 0.015, 0.015, 0.001, 0.001])


def add_device_arg(parser: argparse.ArgumentParser) -> None:
    """``--device``: where the port runs (the counterpart of JAX_PLATFORMS)."""
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to run on (default cuda; 'cpu' runs "
                             "the kernels' plain PyTorch versions)")


# -- parsing --------------------------------------------------------------------

def parse_with_config(parser: argparse.ArgumentParser,
                      argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    """Parse argv with ``-c`` YAML values as defaults (CLI flags win).

    Reproduces ConfigArgParse's merge order (train_seg.py:34-36): config
    file < command line.  Path-typed YAML values get ``$VAR`` expansion.
    """
    pre, _ = parser.parse_known_args(argv)
    if pre.config:
        cfg = load_yaml_file(pre.config) or {}
        flat = _flatten(cfg)
        known = {a.dest: a for a in parser._actions}
        defaults = {}
        for key, value in flat.items():
            if key in known:
                action = known[key]
                if isinstance(value, str) and action.type in (env_path,):
                    value = replace_env(value)
                defaults[key] = value
        parser.set_defaults(**defaults)
    return parser.parse_args(argv)


def _flatten(d: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    out = {}
    for k, v in d.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, f"{key}."))
            # also allow leaf access without the group prefix
            out.update({lk: lv for lk, lv in _flatten(v).items() if lk not in out})
        else:
            out[key] = v
    return out


def load_yaml_config(path, overrides: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Load a grouped YAML (base.* / prediction.*) with ``key=value``
    dotted overrides (predict CLI, reference predict.py:20-35)."""
    cfg = load_yaml_file(path) or {}
    for item in overrides or []:
        key, _, value = item.partition("=")
        node = cfg
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = yaml.safe_load(value)
    return cfg


def read_keyfile(path) -> List[str]:
    """Read newline-separated subject keys (train_seg.py:89-95)."""
    with open(replace_env(str(path))) as f:
        return [line.strip() for line in f if line.strip()]


def validate_task_config(hparams, task: str, n_data: int = 1) -> None:
    """Fail fast on config-vs-config mismatches with named-flag messages.

    Every mismatch here would otherwise surface as a shape error deep in the
    loss (loss weights), an uneven batch split, or a silently mis-sampled
    class distribution.
    """
    oc = int(hparams.out_channels)
    if task == "seg":
        w = getattr(hparams, "loss_weight", None)
        if w is not None and len(w) != oc:
            raise SystemExit(
                f"--loss_weight has {len(w)} entries but --out_channels is "
                f"{oc}: the class weights are per output channel")
        n_classes = oc
    else:
        reg = list(hparams.loss_regression_weight)
        n_classes = oc - len(reg)
        if n_classes < 1:
            raise SystemExit(
                f"--out_channels {oc} must exceed the number of heatmaps "
                f"len(--loss_regression_weight)={len(reg)}: the first "
                f"{len(reg)} output channels regress heatmaps and the rest "
                f"are class logits (reference landmarks.py:57,74-75)")
        w = getattr(hparams, "loss_class_weight", None)
        if w is not None and len(w) != n_classes:
            raise SystemExit(
                f"--loss_class_weight has {len(w)} entries but the class "
                f"head has {n_classes} channels (--out_channels {oc} minus "
                f"{len(reg)} heatmap channels)")
    cp = getattr(hparams, "class_probabilities", None)
    if cp is not None and len(cp) > n_classes:
        raise SystemExit(
            f"--class_probabilities has {len(cp)} entries but the task has "
            f"only {n_classes} classes ({'--out_channels' if task == 'seg' else '--out_channels minus the heatmap channels'})"
            f" — the sampler draws the patch-center class from this "
            f"distribution (index 0 = background)")
    if cp is not None and len(cp) < n_classes:
        # fewer entries is a meaningful choice: classes beyond the list are
        # never drawn as patch centers (configs/seg_brats_bf16.yaml)
        logger.warning(
            "--class_probabilities has %d entries for %d classes: classes "
            ">= %d will never be drawn as patch centers (they still appear "
            "inside patches)", len(cp), n_classes, len(cp))
    if n_data > 1 and int(hparams.batch_size) % n_data:
        raise SystemExit(
            f"--batch_size {hparams.batch_size} is not divisible by the "
            f"data-parallel size {n_data}: the global batch splits evenly")
