"""The port's MIP figures and visualizer hooks against the JAX package's, on the CPU.

- ``make_grid``: exact.
- The renderers, given the same numpy arrays, make the same matplotlib
  calls: their PNG bytes are equal (exact).
- The hooks: JAX's segmentation and landmark hooks run on a fake Trainer
  around a JAX model; the port's render half, given the arrays JAX's hook
  computes, gives the same figures (PNG bytes equal, same tags, titles and
  steps); the port's compute half, on the port model carrying the same
  weights, gives those arrays: inputs and labels exact, class maps equal
  outside the 1e-4 top-2 logit band (the serving tolerance), heatmaps
  atol 1e-4 (the forward's bound).
- Without matplotlib (blocked in a fresh interpreter) the hooks' makers
  warn once, naming it, and return None; ``cli.visualize`` exits 2.
"""

import io
import subprocess
import sys
import textwrap
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from tpu_mednet.models import UNet3DBase, UNetConfig  # noqa: E402
from tpu_mednet.train import create_train_state as jax_create_train_state  # noqa: E402
from tpu_mednet.utils import plots as jax_plots  # noqa: E402
from tpu_mednet_torch.models import ResidualUNet3D  # noqa: E402
from tpu_mednet_torch.utils import plots  # noqa: E402
from tpu_mednet_torch.utils.weights import load_jax_params  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
TIE_BAND = 1e-4


def png(fig) -> bytes:
    buf = io.BytesIO()
    fig.savefig(buf, format="png")
    plt.close(fig)
    return buf.getvalue()


@pytest.mark.parametrize("n,h,w,nrow,padding,pad_value", [
    (1, 5, 7, 8, 2, 0.0), (5, 4, 4, 2, 2, 0.0), (9, 3, 6, 3, 0, 1.5), (16, 8, 8, 8, 1, -1.0)])
def test_make_grid_exact(n, h, w, nrow, padding, pad_value):
    images = np.random.default_rng(n).normal(size=(n, h, w))
    want = jax_plots.make_grid(images, nrow, padding, pad_value)
    got = plots.make_grid(images, nrow, padding, pad_value)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def _volume(seed, c=1, shape=(12, 10, 14)):
    return np.random.default_rng(seed).normal(size=(c, *shape)).astype(np.float32)


def _masks(seed, shape=(12, 10, 14)):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 3, size=shape).astype(np.uint8), \
        rng.integers(0, 3, size=shape).astype(np.int64)


RENDER_CASES = {
    "images_1ch": lambda m: m.vis_logimages(_volume(0)),
    "images_3ch_steps3": lambda m: m.vis_logimages(_volume(1, c=3), steps=3),
    "labels_mean": lambda m: m.vis_loglabels(*_masks(2), inputs=_volume(3)[0]),
    "labels_max_axis2": lambda m: m.vis_loglabels(*_masks(4), mip_axis=2, inputs=_volume(5)[0],
                                                  alpha=0.5, projection_type="max"),
    "labels_no_input": lambda m: m.vis_loglabels(*_masks(6), mip_axis=0),
    "heatmaps_mean": lambda m: m.vis_logheatmaps(
        _volume(7)[0], 255 * np.abs(_volume(8, c=3)), 255 * np.abs(_volume(9, c=3))),
    "heatmaps_max_axis0": lambda m: m.vis_logheatmaps(
        _volume(10)[0], 100 * _volume(11, c=2), 255 * np.abs(_volume(12, c=2)), mip_axis=0,
        alpha=0.4, projection_type="max"),
}


@pytest.mark.parametrize("case", list(RENDER_CASES))
def test_renderers_equal_jax(case):
    want, _ = RENDER_CASES[case](jax_plots)
    got, _ = RENDER_CASES[case](plots)
    assert png(got) == png(want)


def test_renderers_refuse_other_projections():
    with pytest.raises(ValueError, match="projection_type"):
        plots.vis_loglabels(*_masks(0), projection_type="min")
    with pytest.raises(ValueError, match="projection_type"):
        plots.vis_logheatmaps(_volume(0)[0], _volume(1), _volume(2), projection_type="sum")


# -- the hooks against JAX's ---------------------------------------------------


class Figures:
    """A ``trainer.metrics`` that keeps each logged figure's PNG."""

    def __init__(self):
        self.logged = []

    def log_figure(self, tag, fig, step):
        fig.canvas.draw()
        buf = io.BytesIO()
        fig.savefig(buf, format="png")
        self.logged.append((tag, step, fig._suptitle.get_text(), buf.getvalue()))


def _models(out_channels):
    cfg = UNetConfig(in_channels=1, out_channels=out_channels, f_maps=8, num_levels=3,
                     dtype=jnp.float32)
    jmodel = UNet3DBase(config=cfg)
    params = jax_create_train_state(jmodel, (2, 16, 16, 16, 1), 1e-3, seed=0).params
    model = ResidualUNet3D(1, out_channels, f_maps=8, num_levels=3, dtype=torch.float32,
                           device="cpu")
    load_jax_params(model, {"params": jax.tree.map(np.asarray, params)})
    return jmodel, params, model


def _batch(num_heatmaps):
    rng = np.random.default_rng(1)
    shape = (2, 16, 16, 16)
    label = np.zeros((*shape, num_heatmaps + 1), np.uint8)
    label[:, 4:12, 3:11, 5:13, -1] = 1
    label[..., :num_heatmaps] = rng.integers(0, 256, size=(*shape, num_heatmaps))
    data = (rng.normal(size=(*shape, 1)) + 1.5 * label[..., -1:]).astype(np.float32)
    return data, label


def _jax_arrays(jmodel, params, data, label, num_heatmaps):
    """The arrays JAX's hook hands its renderers (tpu_mednet/utils/plots.py)."""
    logits = np.asarray(jmodel.apply({"params": params}, jnp.asarray(data), train=False))
    out = {"inputs": np.moveaxis(data[0], -1, 0), "label": label[0, ..., -1],
           "pred": np.argmax(logits[..., num_heatmaps:], axis=-1)[0],
           "logits": np.moveaxis(logits[0], -1, 0)}
    if num_heatmaps:
        out["gt_heatmaps"] = np.moveaxis(label[0, ..., :-1], -1, 0).astype(np.float32)
        out["out_heatmaps"] = np.moveaxis(logits[0, ..., :num_heatmaps], -1, 0)
    return out


@pytest.mark.parametrize("num_heatmaps,projection", [(0, "mean"), (0, "max"), (3, "mean")],
                         ids=["seg_mean", "seg_max", "landmarks_mean"])
def test_hooks_equal_jax(num_heatmaps, projection):
    classes = 3
    jmodel, params, model = _models(num_heatmaps + classes)
    data, label = _batch(num_heatmaps)
    want_figs = Figures()
    jtrainer = SimpleNamespace(metrics=want_figs, task=SimpleNamespace(model=jmodel),
                               state=SimpleNamespace(params=params, batch_stats=None, step=7))
    jhook = (jax_plots.make_landmark_sample_visualizer(num_heatmaps, projection)
             if num_heatmaps else jax_plots.make_seg_sample_visualizer(projection))
    jhook(jtrainer, {"data": jnp.asarray(data), "label": jnp.asarray(label)}, 2, 5)
    want = _jax_arrays(jmodel, params, data, label, num_heatmaps)

    # the render half on JAX's arrays: the same figures
    render = plots.render_landmark_sample if num_heatmaps else plots.render_seg_sample
    got_figs = Figures()
    for tag, fig in render(want, 2, 5, projection):
        got_figs.log_figure(tag, fig, 7)
        plt.close(fig)
    assert [f[:3] for f in got_figs.logged] == [f[:3] for f in want_figs.logged]
    assert [f[2] for f in got_figs.logged] == ["epoch 2 batch 5"] * len(got_figs.logged)
    assert len(got_figs.logged) == (3 if num_heatmaps else 2)
    for g, w in zip(got_figs.logged, want_figs.logged):
        assert g[3] == w[3], g[0]

    # the compute half on the port model: the arrays
    to = lambda a: torch.from_numpy(a).permute(0, 4, 1, 2, 3)
    trainer = SimpleNamespace(state=SimpleNamespace(model=model, step=7))
    batch = {"data": to(data), "label": to(label)}
    got = (plots.landmark_sample_arrays(trainer, batch, num_heatmaps) if num_heatmaps
           else plots.seg_sample_arrays(trainer, batch))
    assert sorted(got) == sorted(k for k in want if k != "logits")
    assert np.array_equal(got["inputs"], want["inputs"])
    assert np.array_equal(got["label"], want["label"])
    top2 = np.sort(want["logits"][num_heatmaps:], axis=0)
    clear = (top2[-1] - top2[-2]) > TIE_BAND
    assert np.array_equal(got["pred"][clear], want["pred"][clear])
    if num_heatmaps:
        assert np.array_equal(got["gt_heatmaps"], want["gt_heatmaps"])
        np.testing.assert_allclose(got["out_heatmaps"], want["out_heatmaps"], rtol=0, atol=1e-4)

    # the hook itself: the figures it logs at the state's step
    hook = (plots.make_landmark_sample_visualizer(num_heatmaps, projection) if num_heatmaps
            else plots.make_seg_sample_visualizer(projection))
    trainer.metrics = Figures()
    hook(trainer, batch, 2, 5)
    assert [f[:3] for f in trainer.metrics.logged] == [f[:3] for f in want_figs.logged]
    trainer.metrics = None  # a rank that writes nothing: no forward, no figure
    hook(trainer, batch, 2, 5)


def test_without_matplotlib_the_hooks_are_off():
    """matplotlib blocked: one warning naming it, no hook, and the visualize
    CLI exits 2 naming it; the port imports without it."""
    code = textwrap.dedent("""
        import importlib, logging, pkgutil, sys

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] == "matplotlib":
                    raise ImportError(f"{name} is blocked")

        sys.meta_path.insert(0, Block())
        records = []
        handler = logging.Handler()
        handler.emit = records.append
        logging.getLogger().addHandler(handler)
        from tpu_mednet_torch.utils import plots
        from tpu_mednet_torch.cli import visualize
        assert plots.make_seg_sample_visualizer() is None
        assert plots.make_seg_sample_visualizer("max") is None
        assert plots.make_landmark_sample_visualizer(3) is None
        warnings = [r.getMessage() for r in records if r.levelno >= logging.WARNING]
        assert len(warnings) == 1 and "matplotlib" in warnings[0], warnings
        rc = visualize.main(["--data", "x.zarr", "--out", "figs"])
        assert rc == 2, rc
        assert "matplotlib" not in sys.modules
        print("ok")
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    assert proc.stdout.splitlines()[-1] == "ok"
    assert "visualize: matplotlib is not installed" in proc.stderr
