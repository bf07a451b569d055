"""The UNet3D family of the port against the JAX package's, on the CPU.

``DoubleConv``, the concatenation ``DecoderStage``, ``FinalConv`` and
``UNet3D`` (f_maps 8, 2-3 levels, orders ``gcr``, ``crg``, ``cbr``) in
fp32, with the JAX package's weights (and ``batch_stats``, moved away from
their init) carried across by ``state_dict_from_jax``; the reference's
state-dict layout through import and export; the three stitches in eval
mode; ``unet_train_peak_bytes(block="double")``.

Tolerances: a block's output atol 1e-5; the model's logits atol 1e-4 (the
serving bound on record, ``tests/test_torch_model.py``); the nearest
resize and state dicts exact; masks equal outside the tie band of
``tests/test_torch_tta.py``.
"""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tests.test_torch_tta import (AFFINE, FLIPS, KW, SHAPES, assert_prediction_matches,  # noqa: F401
                                  core_stitch, jax_tile_activations, make_store,
                                  one_torch_thread)
from tests.test_torch_weighted import weighted_average
from tpu_mednet.data import MemoryReader as JaxMemoryReader
from tpu_mednet.inference import weighted as jax_weighted
from tpu_mednet.inference.device_sliding import (
    predict_volumes_on_device as jax_predict_volumes_on_device,
)
from tpu_mednet.inference.sliding_window import predict_volumes as jax_predict_volumes
from tpu_mednet.models import UNet3DBase, UNetConfig
from tpu_mednet.models import blocks as jax_blocks
from tpu_mednet.models.unet import UNet3D as JaxUNet3D
from tpu_mednet.tasks import SegmentationTask as JaxSegmentationTask
from tpu_mednet.utils import memory as jax_memory
from tpu_mednet.utils.torch_export import flax_to_state_dict
from tpu_mednet.utils.torch_import import convert_state_dict
from tpu_mednet.utils.torch_import import infer_architecture as jax_infer_architecture
from tpu_mednet_torch.data import MemoryReader
from tpu_mednet_torch.inference import predict_volumes, predict_volumes_on_device, weighted
from tpu_mednet_torch.models import DoubleConv, FinalConv, UNet3D, blocks
from tpu_mednet_torch.models import UNetConfig as PortUNetConfig
from tpu_mednet_torch.models.unet import UNet3DBase as PortUNet3DBase
from tpu_mednet_torch.tasks import SegmentationTask
from tpu_mednet_torch.utils import memory, torch_import
from tpu_mednet_torch.utils.torch_export import save_reference_checkpoint
from tpu_mednet_torch.utils.weights import load_jax_params, state_dict_from_jax

CL3D = torch.channels_last_3d
UNET3D_PARAMS = 16_318_821  # UNet3D(1, 3) at its defaults


def _np_tree(tree):
    return jax.tree.map(np.array, tree)


def _to_port(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a).permute(0, 4, 1, 2, 3).contiguous(memory_format=CL3D)


def _from_port(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 4, 1).numpy()


def _moved_stats(variables, seed=5):
    """``variables`` with every BatchNorm's running mean and variance
    drawn away from flax's init (0 and 1)."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        if name == "mean":
            return rng.normal(0, 0.3, leaf.shape).astype(np.float32)
        return rng.uniform(0.5, 2.0, leaf.shape).astype(np.float32)

    if "batch_stats" in variables:
        variables["batch_stats"] = jax.tree_util.tree_map_with_path(
            draw, variables["batch_stats"])
    return variables


def _stage_state(kind, variables):
    """A stage's JAX variables (``kind`` ``encoder`` or ``decoder``) as the
    port stage's state dict, through the whole-model converter: the tree
    put at stage 0 beside an empty double-family encoder."""
    stage = {"block": variables["params"]} if kind == "encoder" else variables["params"]
    wrap = {"params": {"encoder0": {"block": {}}, f"{kind}0": stage}}
    if "batch_stats" in variables:
        st = variables["batch_stats"]
        wrap["batch_stats"] = {f"{kind}0": {"block": st} if kind == "encoder" else st}
    prefix = f"{kind}s.0."
    return {k[len(prefix):]: t for k, t in state_dict_from_jax(wrap).items()
            if k.startswith(prefix)}


@pytest.mark.parametrize("encoder,c_in,c_out,mid", [(True, 1, 64, 32), (True, 64, 128, 64),
                                                    (True, 24, 32, 24), (False, 24, 8, 8)])
def test_double_conv_mid_channels_and_forward(encoder, c_in, c_out, mid):
    """The encoder's first conv goes to max(out // 2, in), the decoder's to
    out (components.py:93-133); the block's forward equals JAX's."""
    port = DoubleConv(c_in, c_out, encoder=encoder, order="crg", num_groups=4, device="cpu")
    assert port.SingleConv1.conv.weight.shape[:2] == (mid, c_in)
    assert port.SingleConv2.conv.weight.shape[:2] == (c_out, mid)
    if c_in > 24:
        return
    ref = jax_blocks.DoubleConv(out_channels=c_out, encoder=encoder, order="crg",
                                num_groups=4)
    x = np.random.default_rng(0).normal(size=(2, 5, 6, 7, c_in)).astype(np.float32)
    v = _np_tree(ref.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    port.load_state_dict({k[len("basic_module."):]: t
                          for k, t in _stage_state("encoder", v).items()}, strict=True)
    with torch.no_grad():
        y = port.eval()(_to_port(x))
    np.testing.assert_allclose(_from_port(y), np.asarray(ref.apply(v, jnp.asarray(x))),
                               atol=1e-5)


@pytest.mark.parametrize("n_in,n_out", [(12, 25), (3, 7), (6, 13), (4, 8), (5, 10)])
def test_nearest_resize_is_jax_nearest(n_in, n_out):
    """JAX's nearest resize uses half-pixel centres: torch's
    ``nearest-exact``; torch's ``nearest`` differs wherever out / in is
    not an integer (12 -> 25: [0, 0, 0, 1, ...] against [0, 0, 1, 1, ...])."""
    x = np.arange(n_in, dtype=np.float32).reshape(1, n_in, 1, 1, 1)
    want = np.asarray(jax_blocks.resize_nearest(jnp.asarray(x), (n_out, 1, 1)))[0, :, 0, 0, 0]
    got = blocks.resize_nearest(_to_port(x), (n_out, 1, 1))[0, 0, :, 0, 0].numpy()
    np.testing.assert_array_equal(got, want)
    floor = F.interpolate(_to_port(x), size=(n_out, 1, 1), mode="nearest")[0, 0, :, 0, 0]
    assert np.array_equal(floor.numpy(), want) == (n_out % n_in == 0)


@pytest.mark.parametrize("order", ["gcr", "cbr"])
def test_concat_decoder_stage_at_odd_extent_matches_jax(order):
    """12 -> 25 along the first axis, 6 -> 13 and 4 -> 8 along the others:
    the deeper feature resized to the skip's extent, concatenated after it."""
    rng = np.random.default_rng(1)
    enc = rng.normal(size=(2, 25, 13, 8, 8)).astype(np.float32)
    x = rng.normal(size=(2, 12, 6, 4, 16)).astype(np.float32)
    ref = jax_blocks.DecoderStage(out_channels=8, block="double", order=order, num_groups=4)
    v = _moved_stats(_np_tree(ref.init(jax.random.PRNGKey(2), jnp.asarray(enc),
                                       jnp.asarray(x), train=False)))
    want = np.asarray(ref.apply(v, jnp.asarray(enc), jnp.asarray(x), train=False))
    port = blocks.DecoderStage(16, 8, block="double", order=order, num_groups=4, device="cpu")
    assert not hasattr(port, "upsample")
    port.load_state_dict(_stage_state("decoder", v), strict=True)
    with torch.no_grad():
        y = port.eval()(_to_port(enc), _to_port(x))
    assert tuple(y.shape) == (2, 8, 25, 13, 8)
    np.testing.assert_allclose(_from_port(y), want, atol=1e-5)


def test_final_conv_matches_jax():
    x = np.random.default_rng(3).normal(size=(2, 6, 5, 7, 8)).astype(np.float32)
    ref = jax_blocks.FinalConv(out_channels=3, order="cgr", num_groups=4)
    v = _np_tree(ref.init(jax.random.PRNGKey(3), jnp.asarray(x)))
    p = v["params"]
    port = FinalConv(8, 3, order="cgr", num_groups=4, device="cpu")
    conv = p["conv"]
    port.load_state_dict({
        "conv.conv.weight": torch.from_numpy(conv["conv"]["kernel"].transpose(4, 3, 0, 1, 2).copy()),
        "conv.groupnorm.weight": torch.from_numpy(conv["groupnorm"]["scale"]),
        "conv.groupnorm.bias": torch.from_numpy(conv["groupnorm"]["bias"]),
        "final_conv.weight": torch.from_numpy(
            p["final_conv"]["kernel"].transpose(4, 3, 0, 1, 2).copy()),
        "final_conv.bias": torch.from_numpy(p["final_conv"]["bias"]),
    }, strict=True)
    with torch.no_grad():
        y = port(_to_port(x))
    np.testing.assert_allclose(_from_port(y), np.asarray(ref.apply(v, jnp.asarray(x))),
                               atol=1e-5)


def _pair(order, f_maps=8, num_levels=3, out=3, seed=0):
    """(JAX model, its variables with moved batch statistics, port model)."""
    jmodel = JaxUNet3D(1, out, f_maps=f_maps, num_levels=num_levels, layer_order=order,
                       dtype=jnp.float32)
    v = _moved_stats(_np_tree(jmodel.init(jax.random.PRNGKey(seed),
                                          jnp.zeros((1, 8, 8, 8, 1)), train=False)))
    port = UNet3D(1, out, f_maps=f_maps, num_levels=num_levels, layer_order=order,
                  dtype=torch.float32, device="cpu")
    load_jax_params(port, v)
    return jmodel, v, port


@pytest.mark.parametrize("shape", [(16, 16, 16), (12, 10, 9), (13, 17, 11)])
@pytest.mark.parametrize("order", ["gcr", "crg", "cbr"])
def test_unet3d_forward_matches_jax(order, shape):
    """Eval-mode logits at the serving tolerance, at extents divisible by
    2^(levels - 1) and not (the concat join resizes; no divisibility check)."""
    jmodel, v, port = _pair(order)
    x = np.random.default_rng(4).normal(size=(2, *shape, 1)).astype(np.float32)
    want = np.asarray(jmodel.apply(v, jnp.asarray(x), train=False))
    with torch.inference_mode():
        y = port.eval()(_to_port(x))
    assert y.dtype == torch.float32 and tuple(y.shape) == (2, 3, *shape)
    np.testing.assert_allclose(_from_port(y), want, atol=1e-4)


def test_unet3d_state_dict_is_the_reference_tree():
    """Full width (16,318,821 parameters): the keys and shapes of JAX's
    tree converted, the reference's names, BatchNorm buffers for ``b``."""
    jmodel = JaxUNet3D(1, 3)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0),
                                                jnp.zeros((1, 16, 16, 16, 1)), train=False))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    port = UNet3D(1, 3, device="meta")
    assert sum(p.numel() for p in port.parameters()) == UNET3D_PARAMS
    sd = port.state_dict()
    converted = state_dict_from_jax(zeros)
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        k: tuple(v.shape) for k, v in converted.items()}
    assert "encoders.0.basic_module.SingleConv1.groupnorm.weight" in sd
    assert tuple(sd["encoders.0.basic_module.SingleConv1.groupnorm.weight"].shape) == (1,)
    assert tuple(sd["decoders.0.basic_module.SingleConv1.groupnorm.weight"].shape) == (768,)
    assert not any("upsample" in k for k in sd)
    cbr = UNet3D(1, 3, f_maps=8, num_levels=2, layer_order="cbr", device="cpu").state_dict()
    for leaf in ("weight", "bias", "running_mean", "running_var", "num_batches_tracked"):
        assert f"encoders.0.basic_module.SingleConv1.batchnorm.{leaf}" in cbr
    assert "encoders.0.basic_module.SingleConv1.conv.bias" not in cbr


def test_family_options_and_checks():
    """``block`` takes the two families; the divisibility check stays with
    the residual sum join; ``init_parameters_`` resets BatchNorm."""
    with pytest.raises(ValueError, match="block must be"):
        PortUNet3DBase(PortUNetConfig(1, 2, block="packed"), device="cpu")
    with pytest.raises(ValueError, match="repeats"):
        blocks.ConvLayer(4, 8, order="cbgb", device="cpu")
    port = UNet3D(1, 2, f_maps=8, num_levels=3, layer_order="cbr", device="cpu",
                  generator=torch.Generator().manual_seed(1))
    bn = port.encoders[0].basic_module.SingleConv1.batchnorm
    # encoder 0: 1 -> max(8 // 2, 1) = 4 channels in its first conv
    assert torch.equal(bn.running_var, torch.ones(4)) and torch.equal(bn.weight, torch.ones(4))
    with torch.inference_mode():
        assert tuple(port(torch.zeros(1, 1, 9, 7, 5)).shape) == (1, 2, 9, 7, 5)


@pytest.mark.parametrize("batch,remat", [(4, 0), (8, 0), (16, 0), (4, 1), (8, 1), (16, 1),
                                         (8, True), (2, 2)])
def test_double_train_estimate_is_jax_with_jax_constants(monkeypatch, batch, remat):
    """The double branch (two convs a stage, live encoder skips, the concat
    temporaries outside the factor) with the JAX package's constants is
    JAX's estimate; with the port's, it falls with remat and rises with
    the batch."""
    kw = dict(patch=(96, 96, 96), feature_maps=[64, 128, 256, 512], in_channels=1,
              out_channels=3, n_params=UNET3D_PARAMS, block="double")
    ours = memory.unet_train_peak_bytes(batch, remat=remat, **kw)
    assert memory.unet_train_peak_bytes(batch, remat=True, **kw) < ours or remat is True
    assert memory.unet_train_peak_bytes(batch + 1, remat=remat, **kw) > ours
    monkeypatch.setattr(memory, "TRAIN_OVERHEAD", jax_memory.XLA_OVERHEAD)
    monkeypatch.setattr(memory, "DOUBLE_OVERHEAD", jax_memory.XLA_OVERHEAD)
    monkeypatch.setattr(memory, "GN_F32_UNITS", jax_memory.GN_F32_UNITS)
    monkeypatch.setattr(memory, "TRAIN_WORK_UNITS", 0.0)
    monkeypatch.setattr(memory, "JOIN_UNITS", 1.0)
    assert memory.unet_train_peak_bytes(batch, remat=remat, **kw) == \
        jax_memory.unet_train_peak_bytes(batch, remat=remat, **kw)


@pytest.mark.parametrize("order,first", [("gcr", True), ("bcr", True), ("cbr", False),
                                         ("crg", False), ("cgr", False), ("cr", False)])
def test_guard_counts_the_double_family_join(order, first):
    """The HBM guard's working set for the double family: the residual
    family's, plus ``JOIN_INFER_UNITS`` full-resolution concatenations and,
    where the order normalizes before it convolves, ``NORM_FIRST_UNITS``
    more; the residual family's estimate does not depend on the order."""
    assert memory.norm_before_conv(order) == first
    args = ((192, 192, 192), (96, 96, 96), (16, 16, 16), 8, 1, 1, [64, 128, 256, 512])
    residual, _ = memory.device_stitch_bytes(*args, layer_order=order)
    assert residual == memory.device_stitch_bytes(*args)[0]
    double, parts = memory.device_stitch_bytes(*args, block="double", layer_order=order)
    join = 8 * 96**3 * (64 + 128) * 2
    units = memory.JOIN_INFER_UNITS + (memory.NORM_FIRST_UNITS if first else 0.0)
    assert abs(double - residual - units * join) <= 2
    assert parts["forward_working_set"] > 0


# -- the reference's state dict: import, export ----------------------------------

@pytest.mark.parametrize("order", ["crg", "cbr"])
def test_reference_state_dict_import_and_export_equal_jax(tmp_path, order):
    """A reference-layout UNet3D state dict (written by the JAX package's
    ``flax_to_state_dict``, ``num_batches_tracked`` set to 5 as a trained
    torch model's would be) strict-loads into the port's ``UNet3D``; its
    architecture reads as JAX reads it; the port's export of what it loaded
    equals the JAX package's export of its import, key for key, dtype and
    bits (the count written as 0 by both: flax keeps none); the loaded
    model's logits equal JAX's on the imported variables."""
    jmodel, v, _ = _pair(order, f_maps=8, num_levels=2)
    ref_sd = {k: torch.from_numpy(np.array(a, copy=True)) for k, a in flax_to_state_dict(v).items()}
    for k in ref_sd:
        if k.endswith("num_batches_tracked"):
            ref_sd[k] = torch.tensor(5)
    assert torch_import.infer_architecture(ref_sd) == jax_infer_architecture(
        {k: t.numpy() for k, t in ref_sd.items()})

    port = UNet3D(1, 3, f_maps=8, num_levels=2, layer_order=order, dtype=torch.float32,
                  device="cpu")
    torch_import.check_against_template(ref_sd, port.state_dict())
    port.load_state_dict(ref_sd, strict=True)
    jvars = convert_state_dict({k: t.numpy() for k, t in ref_sd.items()})
    want = flax_to_state_dict(jvars)
    save_reference_checkpoint(tmp_path / "x.ckpt", port.state_dict(), hparams={"fmaps": 8})
    with torch.serialization.safe_globals([argparse.Namespace]):
        got = torch.load(tmp_path / "x.ckpt", weights_only=True)["state_dict"]
    assert sorted(got) == sorted(want)
    for k, a in want.items():
        assert got[k].numpy().dtype == np.asarray(a).dtype, k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(a), err_msg=k)

    x = np.random.default_rng(6).normal(size=(1, 12, 12, 12, 1)).astype(np.float32)
    with torch.inference_mode():
        y = port.eval()(_to_port(x))
    np.testing.assert_allclose(_from_port(y), np.asarray(jmodel.apply(
        jvars, jnp.asarray(x), train=False)), atol=1e-4)


# -- serving in eval mode --------------------------------------------------------

def _task_pair(order="cbr"):
    """(JAX task, variables, port task) of a 2-level UNet3D whose running
    statistics are away from their init; the port's model left in training
    mode: the predictors put it in eval mode themselves."""
    jmodel, v, _ = _pair(order, f_maps=8, num_levels=2, out=2)
    # a head that separates the classes: the tie band then holds few voxels
    v["params"]["final_conv"]["kernel"] *= 20.0
    port = UNet3D(1, 2, f_maps=8, num_levels=2, layer_order=order, dtype=torch.float32,
                  device="cpu")
    load_jax_params(port, v)
    port.train()
    return JaxSegmentationTask(model=jmodel, loss="DICE"), v, SegmentationTask(model=port)


@pytest.mark.parametrize("flips", [(), FLIPS], ids=["no_tta", "tta"])
@pytest.mark.parametrize("stitch", ["crop", "device", "gaussian_device", "gaussian_host"])
def test_stitches_in_eval_mode_match_jax(stitch, flips):
    jtask, variables, task = _task_pair()
    store, attrs = make_store()
    keys = list(SHAPES)
    if stitch == "crop":
        ref = jax_predict_volumes(jtask, variables, None, keys, reader=JaxMemoryReader(store),
                                  pad_mode="constant", tta_flips=flips, **KW)
        got = predict_volumes(task, None, keys, reader=MemoryReader(store, attrs),
                              device="cpu", tta_flips=flips, **KW)
    elif stitch == "device":
        ref = jax_predict_volumes_on_device(jtask, variables, None, keys,
                                            reader=JaxMemoryReader(store, attrs),
                                            tta_flips=flips, **KW)
        got = predict_volumes_on_device(task, None, keys, reader=MemoryReader(store, attrs),
                                        device="cpu", tta_flips=flips, **KW)
    else:
        name = ("predict_volumes_weighted_on_device" if stitch == "gaussian_device"
                else "predict_volumes_weighted")
        ref = getattr(jax_weighted, name)(jtask, variables, None, keys,
                                          reader=JaxMemoryReader(store, attrs),
                                          tta_flips=flips, **KW)
        got = getattr(weighted, name)(task, None, keys, reader=MemoryReader(store, attrs),
                                      device="cpu", tta_flips=flips, **KW)
    assert not task.model.training
    for key in keys:
        act, corners, padded = jax_tile_activations(jtask, variables, store["images"][key],
                                                    flips)
        avg = (weighted_average(act, corners, padded, SHAPES[key]) if "gaussian" in stitch
               else core_stitch(act, corners, padded, SHAPES[key]))
        assert_prediction_matches(np.asarray(got[key]), np.asarray(ref[key]), avg, 0,
                                  f"{stitch} {key}")
