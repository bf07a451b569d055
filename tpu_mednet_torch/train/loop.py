"""Training loop: epochs, validation, checkpoints, metrics.

Counterpart of ``tpu_mednet/train/loop.py`` (the pytorch-lightning
``Trainer`` runtime the reference delegates to, train_seg.py:122-132): a
plain loop around the port's train and eval steps with

- host ``PatchSampler``s routed through the native batch pipeline
  (``data/native_loader.py``: the C++ crop/convert/transpose into pinned
  buffers) as the JAX Trainer does, ``native_loader`` None = auto, True =
  require, False = the numpy sampler, and fed through ``device_prefetch``
  (a copy stream, double buffering); ``DevicePatchSampler`` batches used
  as they come;
- checkpoints every epoch (``keep_checkpoints`` retained), the best-val
  checkpoint under ``<model_dir>/best``, resume from ``step //
  steps_per_epoch``, graceful preemption (``PreemptionGuard``);
- early stopping, the plateau schedule, the non-finite policies, and
  JSONL/TensorBoard scalars under the reference's names;
- the profiler hook: with ``profile_dir``, steps 1 to ``profile_steps`` of
  epoch 0 are traced with ``torch.profiler`` (CPU and CUDA) into a Chrome
  trace under ``profile_dir`` (no CLI flag sets it, as in the JAX
  package), which holds the program's spans (``utils/tracing.py``: each
  step's ``train.step`` and its phases, the device sampler's batches);
- the MIP sample visualizer (``utils/plots.py``), called on every
  ``log_interval``-th validation batch, and extra metric sinks (Neptune);
- data parallelism over a ``parallel.mesh.DataMesh``: ``batch_size`` is
  the global batch; each rank steps on its rows of it (a host sampler's
  node batch split between the node's ranks, or the device sampler's
  global draw gathered for the rank's rows alone) through the data-
  parallel steps, and rank 0 alone writes logs, figures and checkpoints,
  where the JAX package's one controller writes them once;
- spatial partitioning over a mesh with a space axis (JAX's Trainer over a
  (data, space) mesh): the ranks of a data row take that row's rows of
  the host sampler's batch at the full patch extent and the steps cut
  their X slabs; JAX's refusals stand (the device sampler, a space axis
  across nodes, a patch X extent the axis does not divide).  The MIP
  visualizer's forward runs on rank 0 alone on the whole first row, with
  no collective (the steps leave the model off the space axis).

Metrics stay on the device: the loop reads them every ``log_every``
steps, and validation sums them on the device and reads them once per
epoch.
"""

from __future__ import annotations

import dataclasses
import logging
import signal
import threading
import time
from pathlib import Path
from typing import Callable, Dict, Optional

import torch

from tpu_mednet_torch.data.device_sampler import DevicePatchSampler
from tpu_mednet_torch.data.native_loader import make_batch_source
from tpu_mednet_torch.data.patch_sampler import PatchSampler
from tpu_mednet_torch.data.prefetch import device_prefetch
from tpu_mednet_torch.models.unet import create_feature_maps
from tpu_mednet_torch.ops.augment import AugmentConfig
from tpu_mednet_torch.parallel.mesh import DataMesh
from tpu_mednet_torch.parallel.multihost import local_batch_size, take_rows
from tpu_mednet_torch.train.checkpoint import CheckpointManager
from tpu_mednet_torch.train.optim import (
    OptimizerConfig,
    PlateauController,
    check_resume_optimizer,
    read_current_lr,
)
from tpu_mednet_torch.train.state import TrainState, create_train_state, param_count
from tpu_mednet_torch.train.step import make_eval_step, make_train_step
from tpu_mednet_torch.utils.metrics_logging import MetricsLogger

logger = logging.getLogger(__name__)


def _check_resume_architecture(hp_prev: dict, config, resume) -> None:
    """Refuse a --resume whose CLI hparams build a different model.

    Compares the checkpoint's in/out channels and per-level feature maps
    (an int ``fmaps`` expands over the default 5 levels), or a Swin
    UNETR's ``feature_size``, with the model the Trainer was given."""
    problems = []
    for key, ours in (("in_channels", config.in_channels),
                      ("out_channels", config.out_channels)):
        theirs = hp_prev.get(key)
        if theirs is not None and int(theirs) != int(ours):
            problems.append(f"{key}: checkpoint {theirs} vs CLI {ours}")
    swin = hasattr(config, "feature_size")
    if swin != (hp_prev.get("arch", "ResidualUNet3D") == "SwinUNETR"):
        problems.append(f"arch: checkpoint {hp_prev.get('arch', 'ResidualUNet3D')} vs CLI "
                        f"{'SwinUNETR' if swin else 'ResidualUNet3D'}")
    elif swin:
        fs = hp_prev.get("feature_size", 48)
        if int(fs) != config.feature_size:
            problems.append(f"feature_size: checkpoint {fs} vs CLI {config.feature_size}")
    fm = hp_prev.get("fmaps")
    if fm is not None and not swin:
        theirs = (create_feature_maps(int(fm), 5) if not isinstance(fm, (list, tuple))
                  else tuple(int(x) for x in fm))
        if theirs != tuple(config.feature_maps):
            problems.append(
                f"feature maps: checkpoint {theirs} vs CLI {tuple(config.feature_maps)}")
    if problems:
        raise ValueError(
            f"--resume {resume}: the checkpoint was trained with a "
            f"different architecture ({'; '.join(problems)}). Pass matching "
            "--fmaps/--in_channels/--out_channels (per-level fmaps lists "
            "can be given via the -c YAML config)."
        )


class NonFiniteError(RuntimeError):
    """Raised when training hits NaN/Inf under ``nonfinite='terminate'``
    (or when every step of an epoch was skipped under 'skip').  The last
    checkpoint written before the raise holds only finite parameters."""


class PreemptionGuard:
    """Graceful preemption: the first SIGTERM/SIGINT only sets a flag, so
    the loop finishes the step in flight, saves a checkpoint and returns
    (``--resume`` continues from it); a second signal raises
    ``KeyboardInterrupt``.  A no-op off the main thread."""

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self.triggered = False
        self._signals = signals
        self._old: Dict[int, object] = {}

    def _on_signal(self, signum, frame):
        if self.triggered:
            raise KeyboardInterrupt(f"second signal {signum} during shutdown")
        self.triggered = True
        logger.warning(
            "received signal %d: finishing the in-flight step, then "
            "checkpointing and exiting (send again to abort hard)", signum,
        )

    def __enter__(self) -> "PreemptionGuard":
        if threading.current_thread() is threading.main_thread():
            for sig in self._signals:
                try:
                    self._old[sig] = signal.signal(sig, self._on_signal)
                except (ValueError, OSError):  # pragma: no cover
                    pass
        return self

    def __exit__(self, *exc) -> None:
        for sig, old in self._old.items():
            signal.signal(sig, old)
        self._old.clear()


class Trainer:
    """Runs a task (``SegmentationTask`` or ``LandmarkTask``) over train/val
    patch samplers on the task model's device; with a ``mesh`` of more
    than one rank, as one rank of a data-parallel run (module docstring)."""

    def __init__(
        self,
        task,
        train_sampler,
        val_sampler=None,
        batch_size: int = 4,
        max_epochs: int = 100,
        learning_rate: float = 1e-3,
        model_dir: Optional[str] = None,
        log_dir: Optional[str] = None,
        augment: Optional[AugmentConfig] = None,
        seed: int = 0,
        log_every: int = 10,
        hparams: Optional[dict] = None,
        native_loader: Optional[bool] = None,
        optim: Optional[OptimizerConfig] = None,
        check_val_every_n_epoch: int = 1,
        early_stop_patience: int = 0,
        early_stop_min_delta: float = 0.0,
        limit_train_batches: int = 0,
        limit_val_batches: int = 0,
        nonfinite: str = "off",
        track_grad_norm: bool = False,
        keep_checkpoints: int = 3,
        profile_dir: Optional[str] = None,
        profile_steps: int = 5,
        sample_visualizer: Optional[Callable] = None,
        log_interval: int = 5,
        metric_sinks=(),
        mesh: Optional[DataMesh] = None,
    ):
        self.task = task
        self.device = next(task.model.parameters()).device
        self.mesh = mesh if mesh is not None else DataMesh(devices=(self.device,))
        writer = self.mesh.rank == 0  # logs, figures and checkpoints: rank 0 alone
        n_space = self.mesh.n_space
        if n_space > 1:
            if isinstance(train_sampler, DevicePatchSampler):
                raise ValueError(
                    "spatial partitioning requires the host sampler "
                    "(DevicePatchSampler gathers its own sharding)")
            if self.mesh.node_count > 1 and self.mesh.ranks_per_node % n_space:
                n_local = self.mesh.ranks_per_node
                raise ValueError(
                    f"spatial partitioning across process boundaries "
                    f"is not supported: the 'space' axis ({n_space}) "
                    f"must divide the per-process device count "
                    f"({n_local}) so every host owns whole spatial "
                    f"rows of the mesh")
            px = int(train_sampler.patch_size[0])
            if px % n_space:
                raise ValueError(
                    f"patch X extent {px} not divisible by the 'space' "
                    f"axis ({n_space})")

        # host PatchSamplers go through the native batch pipeline (fused C++
        # crop/convert/transpose into pinned buffers for the card), as in the
        # JAX Trainer: byte-identical batches, so only a throughput knob
        def route(s):
            if native_loader is not False and isinstance(s, PatchSampler):
                return make_batch_source(s, use_native=native_loader,
                                         pinned=self.device.type == "cuda")
            return s

        self.train_sampler = route(train_sampler)
        self.val_sampler = route(val_sampler) if val_sampler is not None else None
        self.batch_size = batch_size
        self.max_epochs = max_epochs
        self.learning_rate = learning_rate
        self.seed = seed
        self.log_every = log_every
        self.hparams = hparams
        self.profile_dir = profile_dir
        self.profile_steps = profile_steps
        self._profiler = None
        self._preempt: Optional[PreemptionGuard] = None
        self.sample_visualizer = sample_visualizer
        self.log_interval = log_interval

        self.metrics = MetricsLogger(log_dir, extra_sinks=metric_sinks) \
            if log_dir and writer else None
        if keep_checkpoints < 1:
            raise ValueError(f"keep_checkpoints must be >= 1, got {keep_checkpoints}")
        self.ckpt = CheckpointManager(model_dir, max_to_keep=keep_checkpoints) \
            if model_dir and writer else None
        self._last_saved_step: Optional[int] = None
        # best-val checkpoint (PL 0.9's default ModelCheckpoint, reference
        # train_seg.py:122-131): one step under <model_dir>/best, written when
        # `monitor` improves
        self.monitor = "val_loss"
        if check_val_every_n_epoch < 1:
            raise ValueError("check_val_every_n_epoch must be >= 1")
        self.check_val_every_n_epoch = check_val_every_n_epoch
        if early_stop_patience and val_sampler is None:
            raise ValueError(
                "early_stop_patience needs a validation set (the monitored "
                f"metric {self.monitor!r} comes from val epochs)")
        self.early_stop_patience = early_stop_patience
        self.early_stop_min_delta = early_stop_min_delta
        self._es_best: Optional[float] = None
        self._es_stale = 0
        self.limit_train_batches = limit_train_batches
        self.limit_val_batches = limit_val_batches
        self._model_dir = model_dir
        self._best_value: Optional[float] = None
        self._ckpt_best: Optional[CheckpointManager] = None
        self.state: Optional[TrainState] = None

        # rows a batch: a host sampler draws this node's share of the global
        # batch and each of the node's ranks takes its rows; the device
        # sampler draws the global batch and gathers this rank's rows
        self._node_batch = local_batch_size(batch_size, self.mesh.node_count)
        self._host_rows = self.mesh.rows(self._node_batch, within_node=True)
        self._device_rows = self.mesh.rows(batch_size)
        per_draw = batch_size if isinstance(train_sampler, DevicePatchSampler) \
            else self._node_batch
        self._steps_per_epoch = max(len(self.train_sampler) // per_draw, 1)
        if limit_train_batches:
            self._steps_per_epoch = min(self._steps_per_epoch, limit_train_batches)
        self.optim = (optim or OptimizerConfig(learning_rate=learning_rate)) \
            .resolve_total_steps(self._steps_per_epoch * max_epochs)
        if self.optim.schedule == "plateau" and val_sampler is None:
            raise ValueError(
                "--lr_schedule plateau needs a validation set (the LR "
                f"decays on plateaus of {self.monitor!r})")
        self._plateau = PlateauController(self.optim) \
            if self.optim.schedule == "plateau" else None
        if nonfinite not in ("off", "skip", "terminate"):
            raise ValueError(f"nonfinite must be off/skip/terminate, got {nonfinite!r}")
        self.nonfinite = nonfinite
        # landmark labels carry continuous heatmap targets in their leading
        # channels (heatmaps first, class map last): the spatial transform
        # warps those linearly, like the image, not nearest
        num_hm = int(getattr(task, "num_heatmaps", 0) or 0)
        if (augment is not None and augment.wants_spatial() and num_hm
                and not augment.label_trilinear_channels):
            augment = dataclasses.replace(augment, label_trilinear_channels=num_hm)
        self.augment = augment
        # validation monitors the EMA weights (what gets deployed) when EMA is on
        self.train_step = make_train_step(
            task, augment=augment, ema_decay=self.optim.ema_decay,
            guard_nonfinite=nonfinite != "off", track_grad_norm=track_grad_norm,
            mesh=self.mesh)
        self.eval_step = make_eval_step(task, use_ema=bool(self.optim.ema_decay),
                                        mesh=self.mesh)

    # -- lifecycle --------------------------------------------------------

    def init_state(self, resume: Optional[str] = None) -> TrainState:
        state = create_train_state(self.task.model, self.learning_rate, seed=self.seed,
                                   optimizer=self.optim)
        self.start_epoch = 0
        if resume:
            mgr = self.ckpt if (self.ckpt and str(self.ckpt.directory) == str(
                Path(resume).absolute())) else CheckpointManager(resume)
            # fail fast with the actual numbers when the CLI hparams build
            # another architecture or optimizer than the checkpoint holds
            hp_prev = mgr.restore_hparams()
            if hp_prev:
                _check_resume_architecture(hp_prev, self.task.model.config, resume)
                check_resume_optimizer(hp_prev, self.optim, resume)
            state, _ = mgr.restore(state)
            # continue epoch accounting from the restored step, so a resumed
            # run trains to the original max_epochs (PL resume semantics)
            self.start_epoch = state.step // self._steps_per_epoch
            logger.info("resumed from %s at step %d (epoch %d)", resume, state.step,
                        self.start_epoch)
        logger.info("model parameters: %.2fM", param_count(state) / 1e6)
        # every rank starts from rank 0's weights (each built them from the
        # same seed or restored the same checkpoint: this only makes sure)
        self.mesh.broadcast_(list(state.model.state_dict().values()))
        self.state = state
        if resume and self.ckpt and self._best_dir().exists():
            # carry best-val tracking across the resume, so best/ is only
            # overwritten by a step that beats the best before it
            hp_best = self._best_mgr().restore_hparams() \
                if self._best_mgr().latest_step is not None else None
            info = (hp_best or {}).get("_best_monitor") or {}
            if info.get("metric") == self.monitor and info.get("value") is not None:
                self._best_value = float(info["value"])
                logger.info("resumed best %s=%.6g (step %s)", self.monitor,
                            self._best_value, info.get("step"))
        return state

    # -- checkpoints --------------------------------------------------------

    def _best_dir(self) -> Path:
        return Path(self._model_dir) / "best"

    def _best_mgr(self) -> CheckpointManager:
        if self._ckpt_best is None:
            self._ckpt_best = CheckpointManager(self._best_dir(), max_to_keep=1)
        return self._ckpt_best

    def _maybe_save_best(self, val_means: Dict[str, float]) -> bool:
        """Save ``<model_dir>/best`` when the monitored val metric improves
        (PL 0.9's ModelCheckpoint, monitor='val_loss', save_top_k=1)."""
        if not self.ckpt or self.monitor not in val_means:
            return False
        value = float(val_means[self.monitor])
        if self._best_value is not None and value >= self._best_value:
            return False
        self._best_value = value
        hp = dict(self.hparams or {})
        hp["_best_monitor"] = {"metric": self.monitor, "value": value,
                               "step": self.state.step}
        mgr = self._best_mgr()
        if self.state.step in mgr.available_steps:  # the same step, a better value
            return False
        mgr.save(self.state.step, self.state, hp)
        logger.info("new best %s=%.6g at step %d -> %s", self.monitor, value,
                    self.state.step, self._best_dir())
        return True

    def _save_ckpt(self) -> None:
        """Save a resumable checkpoint at the current step, once per step
        (the step stands still over a fully skipped epoch)."""
        step = self.state.step
        if step == self._last_saved_step or step in self.ckpt.available_steps:
            logger.info("checkpoint at step %d already exists; not re-saving", step)
            return
        t0 = time.perf_counter()
        self.ckpt.save(step, self.state, self.hparams)
        self._last_saved_step = step
        logger.info("saved checkpoint at step %d in %.3f s", step, time.perf_counter() - t0)

    def _should_early_stop(self, val_means: Dict[str, float]) -> bool:
        """PL EarlyStopping(monitor, patience, min_delta, mode='min')."""
        if not self.early_stop_patience or self.monitor not in val_means:
            return False
        value = float(val_means[self.monitor])
        if self._es_best is None or value < self._es_best - self.early_stop_min_delta:
            self._es_best = value
            self._es_stale = 0
            return False
        self._es_stale += 1
        if self._es_stale >= self.early_stop_patience:
            logger.info(
                "early stopping: %s has not improved by > %g for %d val "
                "checks (best %.6g)", self.monitor, self.early_stop_min_delta,
                self._es_stale, self._es_best)
            return True
        return False

    # -- epochs -----------------------------------------------------------

    def _batches(self, sampler, shuffle: bool):
        parallel = self.mesh.parallel
        if isinstance(sampler, DevicePatchSampler):  # already on the card
            return sampler.batches(self.batch_size, shuffle=shuffle,
                                   rows=self._device_rows if parallel else None)
        host_iter = sampler.batches(self._node_batch, shuffle=shuffle)
        if parallel:
            host_iter = (take_rows(b, self._host_rows) for b in host_iter)
        return device_prefetch(host_iter, self.device)

    def train_epoch(self, epoch: int) -> Dict[str, float]:
        last_metrics: Dict[str, float] = {}
        t_start = time.perf_counter()
        n_batches = 0
        nonfinite_acc = None  # device scalar, read once per epoch
        batches = self._batches(self.train_sampler, shuffle=True)
        try:
            for batch in batches:
                if self._preempt is not None and self._preempt.triggered:
                    break
                if self.limit_train_batches and n_batches >= self.limit_train_batches:
                    break
                if self.profile_dir and epoch == 0 and n_batches == 1:
                    self._start_profile()  # skip step 0 (first calls), trace steady steps
                arrays = {"data": batch["data"], "label": batch["label"]}
                self.state, metrics = self.train_step(self.state, arrays)
                if self.nonfinite != "off":
                    nf = metrics["nonfinite"]
                    nonfinite_acc = nf if nonfinite_acc is None else nonfinite_acc + nf
                if self._profiler is not None and n_batches >= self.profile_steps:
                    self._stop_profile(n_batches)
                if n_batches % self.log_every == 0:
                    scalars = {k: float(v) for k, v in metrics.items()}  # waits
                    scalars["lr"] = read_current_lr(self.optim, self.state.optimizer,
                                                    self.state.step)
                    if self.metrics:
                        self.metrics.log_scalars(self.state.step, scalars)
                    last_metrics = scalars
                n_batches += 1
        finally:
            if hasattr(batches, "close"):
                batches.close()
            if self._profiler is not None:
                # the epoch ended (too few batches, preempted, or raised) before
                # the traced window closed: never leave a trace open
                logger.warning("profile trace closed at epoch end after %d steps "
                               "(profile_steps=%d)", n_batches, self.profile_steps)
                self._stop_profile(n_batches - 1)
        if nonfinite_acc is not None and n_batches:
            n_bad = int(float(nonfinite_acc))
            if n_bad:
                logger.warning(
                    "epoch %d: %d/%d steps had a non-finite loss or gradient; "
                    "their updates were skipped", epoch, n_bad, n_batches)
                if self.metrics:
                    self.metrics.log_scalars(self.state.step,
                                             {"nonfinite_steps": float(n_bad)})
                if self.nonfinite == "terminate" or n_bad >= n_batches:
                    if self.ckpt:
                        # the guard skipped every poisoned update
                        self._save_ckpt()
                    reason = ("every step of the epoch was non-finite"
                              if self.nonfinite != "terminate"
                              else "nonfinite='terminate'")
                    raise NonFiniteError(
                        f"epoch {epoch}: {n_bad}/{n_batches} non-finite steps "
                        f"({reason}); last checkpoint holds the finite params "
                        "from before the first bad step")
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall = time.perf_counter() - t_start
        if n_batches:
            pps = n_batches * self.batch_size / wall
            logger.info("epoch %d: %d steps, %.1f patches/s, train_loss=%s",
                        epoch, n_batches, pps, last_metrics.get("train_loss"))
            if self.metrics:
                self.metrics.log_scalars(self.state.step, {"patches_per_sec": pps})
        return last_metrics

    def _start_profile(self) -> None:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self._profiler = torch.profiler.profile(activities=activities)
        self._profiler.start()

    def _stop_profile(self, last_step: int) -> None:
        """Wait for the traced steps' device work, stop the profiler and
        write its Chrome trace under ``profile_dir``."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof, self._profiler = self._profiler, None
        prof.stop()
        out = Path(self.profile_dir)
        out.mkdir(parents=True, exist_ok=True)
        path = out / f"train_steps_1-{last_step}.pt.trace.json"
        prof.export_chrome_trace(str(path))
        logger.info("profile trace of steps 1-%d -> %s", last_step, path)

    def val_epoch(self, epoch: int) -> Dict[str, float]:
        if self.val_sampler is None:
            return {}
        # sum the metrics on the device and read them once per epoch
        sums: Dict[str, torch.Tensor] = {}
        count = 0
        batches = self._batches(self.val_sampler, shuffle=False)
        try:
            for i, batch in enumerate(batches):
                if self.limit_val_batches and i >= self.limit_val_batches:
                    break
                metrics = self.eval_step(self.state, {"data": batch["data"],
                                                      "label": batch["label"]})
                if self.sample_visualizer is not None and i % self.log_interval == 0:
                    self.sample_visualizer(self, batch, epoch, i)
                for k, v in metrics.items():
                    sums[k] = v if k not in sums else sums[k] + v
                count += 1
        finally:
            if hasattr(batches, "close"):
                batches.close()
        if sums:
            values = torch.stack([v.float() for v in sums.values()]).cpu().numpy()
            means = {k: float(v) / max(count, 1) for k, v in zip(sums, values)}
        else:
            means = {}
        if self.metrics and means:
            self.metrics.log_scalars(self.state.step, means)
        if means:
            logger.info("epoch %d validation: %s", epoch, means)
        return means

    def fit(self, resume: Optional[str] = None) -> TrainState:
        if self.state is None:
            self.init_state(resume=resume)
        with PreemptionGuard() as guard:
            self._preempt = guard
            try:
                for epoch in range(self.start_epoch, self.max_epochs):
                    self.train_epoch(epoch)
                    if guard.triggered:
                        if self.ckpt:
                            self._save_ckpt()
                        logger.warning("preempted at step %d (epoch %d): checkpoint "
                                       "saved, exiting", self.state.step, epoch)
                        break
                    val_means = {}
                    if (epoch + 1) % self.check_val_every_n_epoch == 0:
                        val_means = self.val_epoch(epoch)
                        self._maybe_save_best(val_means)
                    if self._plateau is not None and self.monitor in val_means:
                        # decay the live LR before the epoch checkpoint, so
                        # the saved state carries it
                        new_lr = self._plateau.update(self.state.optimizer,
                                                      float(val_means[self.monitor]))
                        if new_lr is not None:
                            logger.info("plateau: %s stale for %d val checks; lr -> %g",
                                        self.monitor, self.optim.lr_plateau_patience,
                                        new_lr)
                    if self.ckpt:
                        self._save_ckpt()
                    if self._should_early_stop(val_means):
                        break
            finally:
                self._preempt = None
                if self.metrics:
                    self.metrics.close()
        return self.state
