"""The port's Neptune sink, figure logging and visualizer hook, against the JAX package.

The neptune client is not installed here: a duck-typed fake module
(``tests/test_observability.py``'s pattern) stands in, and the same calls
go to both packages, whose runs must see the same arguments, assignments
and appends (exact).  ``MetricsLogger.log_figure`` without TensorBoard
writes ``<log_dir>/figures/<tag>_<step>.png`` in both packages.  A 1-epoch
``Trainer.fit`` with the sink and the MIP sample visualizer logs the same
losses and validation means as the port's run without them (exact: the
hook's forward runs in eval mode and draws nothing), every scalar reaches
the sink, and 2 figures reach it per visualized batch.
"""

import sys
import types

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from tpu_mednet.utils import metrics_logging as jax_metrics_logging  # noqa: E402
from tpu_mednet.utils import neptune_logger as jax_neptune  # noqa: E402
from tpu_mednet_torch.data import MemoryReader, PatchSampler  # noqa: E402
from tpu_mednet_torch.models import ResidualUNet3D  # noqa: E402
from tpu_mednet_torch.tasks import SegmentationTask  # noqa: E402
from tpu_mednet_torch.train import Trainer  # noqa: E402
from tpu_mednet_torch.utils import metrics_logging, neptune_logger  # noqa: E402
from tpu_mednet_torch.utils.plots import make_seg_sample_visualizer  # noqa: E402


class FakeHandle:
    def __init__(self, run, key):
        self.run, self.key = run, key

    def append(self, value, step=None):
        self.run.appends.setdefault(self.key, []).append((value, step))


class FakeRun:
    def __init__(self, **kwargs):
        self.kwargs = kwargs
        self.appends = {}
        self.assigned = {}
        self.stopped = False

    def __getitem__(self, key):
        return FakeHandle(self, key)

    def __setitem__(self, key, value):
        self.assigned[key] = value

    def stop(self):
        self.stopped = True


@pytest.fixture
def fake_neptune(monkeypatch):
    mod = types.ModuleType("neptune")
    mod.runs = []

    def init_run(**kwargs):
        run = FakeRun(**kwargs)
        mod.runs.append(run)
        return run

    mod.init_run = init_run
    monkeypatch.setitem(sys.modules, "neptune", mod)
    monkeypatch.setenv("NEPTUNE_API_TOKEN", "fake-token")
    return mod


def both(fake, *args, **kwargs):
    """The JAX and port sinks for the same call, and the runs they made."""
    start = len(fake.runs) if fake is not None else 0
    sinks = [m.maybe_create_neptune_run(*args, **kwargs) for m in (jax_neptune, neptune_logger)]
    return sinks, (fake.runs[start:] if fake is not None else [])


def test_no_project_returns_none(fake_neptune):
    sinks, runs = both(fake_neptune, None, "exp")
    assert sinks == [None, None] and runs == []


def test_no_token_returns_none(monkeypatch, fake_neptune):
    monkeypatch.delenv("NEPTUNE_API_TOKEN")
    sinks, runs = both(fake_neptune, "ws/proj", "exp")
    assert sinks == [None, None] and runs == []


def test_client_missing_warns_and_returns_none(monkeypatch, caplog):
    monkeypatch.setenv("NEPTUNE_API_TOKEN", "fake-token")
    monkeypatch.setitem(sys.modules, "neptune", None)  # the import fails
    with caplog.at_level("WARNING"):
        sinks, _ = both(None, "ws/proj", "exp")
    assert sinks == [None, None]
    messages = [r.getMessage() for r in caplog.records]
    assert len(messages) == 2 and messages[0] == messages[1]
    assert "not installed" in messages[1]


def test_experiment_created_with_hparams_tags_sources(fake_neptune):
    sinks, runs = both(fake_neptune, "ws/proj", "exp1", hparams={"lr": 1e-3, "fmaps": [8, 16]},
                       tags=["seg", "demo"], source_files=["train_seg.py", "cfg.yaml"])
    assert isinstance(sinks[1], neptune_logger.NeptuneSink)
    want, got = runs
    assert got.kwargs == want.kwargs == dict(project="ws/proj", name="exp1",
                                             tags=["seg", "demo"],
                                             source_files=["train_seg.py", "cfg.yaml"])
    assert got.assigned == want.assigned == {"parameters": {"lr": "0.001", "fmaps": "[8, 16]"}}


def test_default_tags_are_experiment_name(fake_neptune):
    _, runs = both(fake_neptune, "ws/proj", "exp2")
    assert [r.kwargs["tags"] for r in runs] == [["exp2"], ["exp2"]]


def test_sink_scalars_figures_and_close(fake_neptune, tmp_path):
    sinks, runs = both(fake_neptune, "ws/proj", "exp")
    fig = plt.figure()
    for name, mod, sink in (("jax", jax_metrics_logging, sinks[0]),
                            ("port", metrics_logging, sinks[1])):
        metrics = mod.MetricsLogger(tmp_path / name, extra_sinks=(sink, None))
        metrics.log_scalars(3, {"train_loss": 0.5, "lr": torch.tensor(1e-3)})
        metrics.log_figure("images", fig, 3)
        metrics.close()
    plt.close(fig)
    want, got = runs
    assert got.appends.keys() == want.appends.keys() == {"train_loss", "lr", "images"}
    assert got.appends["train_loss"] == want.appends["train_loss"] == [(0.5, 3)]
    assert got.appends["lr"] == want.appends["lr"]
    assert got.appends["images"][0][0] is fig and got.appends["images"][0][1] == 3
    assert got.stopped and want.stopped


def test_png_fallback_without_tensorboard(tmp_path, monkeypatch):
    """Without TensorBoard a figure lands as ``figures/<tag>_<step>.png``,
    '/' in the tag made '_', the same bytes as the JAX package's."""
    monkeypatch.setattr(jax_metrics_logging, "SummaryWriter", None)
    monkeypatch.setitem(sys.modules, "tensorboardX", None)
    fig, ax = plt.subplots()
    ax.imshow(np.arange(64.0).reshape(8, 8))
    paths = []
    for name, mod in (("jax", jax_metrics_logging), ("port", metrics_logging)):
        metrics = mod.MetricsLogger(tmp_path / name)
        assert metrics._tb is None
        metrics.log_figure("val/images", fig, 7)
        metrics.close()
        paths.append(tmp_path / name / "figures" / "val_images_000007.png")
    plt.close(fig)
    assert paths[1].stat().st_size > 0
    assert paths[1].read_bytes() == paths[0].read_bytes()
    # use_tensorboard=False takes the same route where tensorboardX imports
    monkeypatch.delitem(sys.modules, "tensorboardX")
    assert metrics_logging.MetricsLogger(tmp_path / "off", use_tensorboard=False)._tb is None


# -- a 1-epoch Trainer.fit with the sink and the visualizer --------------------


def _sampler(samples, seed):
    rng = np.random.default_rng(seed)
    shape = (20, 20, 20)
    lbl = np.zeros((1, *shape), np.uint8)
    lbl[0, 5:13, 5:13, 5:13] = 1
    img = (rng.normal(0, 0.1, size=(1, *shape)) + 2.0 * lbl).astype(np.float32)
    reader = MemoryReader({"images": {"s": img}, "labels": {"s": lbl}})
    return PatchSampler(None, ["s"], samples, patch_size=[16, 16, 16], reader=reader,
                        seed=seed)


def _fit(log_dir, **kw):
    model = ResidualUNet3D(1, 2, f_maps=4, num_levels=2, dtype=torch.float32, device="cpu",
                           generator=torch.Generator().manual_seed(0))
    trainer = Trainer(SegmentationTask(model=model, loss="DICE"), _sampler(4, 0),
                      val_sampler=_sampler(6, 1), batch_size=2, max_epochs=1,
                      log_dir=str(log_dir), log_every=1, native_loader=False, **kw)
    trainer.fit()
    import json

    return [json.loads(line) for line in (log_dir / "metrics.jsonl").read_text().splitlines()]


def test_fit_with_sink_and_visualizer_logs_what_it_logs_without(fake_neptune, tmp_path,
                                                                monkeypatch):
    monkeypatch.setitem(sys.modules, "tensorboardX", None)  # figures as PNGs
    plain = _fit(tmp_path / "plain")
    sink = neptune_logger.maybe_create_neptune_run("ws/proj", "fit", hparams={"lr": 1e-3})
    seen = _fit(tmp_path / "seen", sample_visualizer=make_seg_sample_visualizer("max"),
                log_interval=2, metric_sinks=(sink,))
    strip = lambda recs: [{k: v for k, v in r.items() if k not in ("time", "patches_per_sec")}
                          for r in recs]
    assert strip(seen) == strip(plain)
    (run,) = fake_neptune.runs
    scalars = [(r["step"], k, v) for r in seen for k, v in r.items() if k not in ("step", "time")]
    appended = [(step, k, v) for k, entries in run.appends.items()
                if k not in ("images", "labels") for v, step in entries]
    assert sorted(appended) == sorted(scalars)
    # 3 validation batches (6 patches, batch 2), visualized at 0 and 2: two
    # figures each, named images and labels, at the epoch's step
    assert [s for _, s in run.appends["images"]] == [2, 2]
    assert [s for _, s in run.appends["labels"]] == [2, 2]
    pngs = sorted(p.name for p in (tmp_path / "seen" / "figures").glob("*.png"))
    assert pngs == ["images_000002.png", "labels_000002.png"]
    assert run.stopped
