"""The port's residual U-Net against the JAX package's, on the CPU in fp32.

Seeded port weights go to the JAX tree with the JAX package's own
``convert_state_dict`` and come back bit-exactly with the port's
``state_dict_from_jax``; the same numpy input runs
through ``UNet3DBase.apply`` and the port's forward.  Tolerance: logits
atol 1e-4, the bound the JAX package holds its packed-vs-unpacked forward
to (docs/PERFORMANCE.md:389-390) — the two frameworks sum convolutions and
GroupNorm statistics in different orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_mednet.models import UNet3DBase, UNetConfig
from tpu_mednet.utils.torch_import import convert_state_dict
from tpu_mednet_torch.models import ResidualUNet3D
from tpu_mednet_torch.models import UNetConfig as TorchUNetConfig
from tpu_mednet_torch.models import blocks
from tpu_mednet_torch.models.unet import UNet3DBase as TorchUNet3DBase
from tpu_mednet_torch.utils.weights import load_jax_params, state_dict_from_jax

FULL_WIDTH_PARAMS = 35_316_738


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def jax_variables(port) -> dict:
    """The port's seeded weights as the JAX package's tree, checked to come
    back bit-exactly through ``state_dict_from_jax``."""
    sd = port.state_dict()
    variables = convert_state_dict(sd)
    back = state_dict_from_jax(variables)
    assert sorted(back) == sorted(sd)
    assert all(torch.equal(back[k], sd[k]) for k in sd)
    return variables


@pytest.mark.parametrize("packed", [False, True])
def test_forward_matches_jax(packed):
    port = ResidualUNet3D(1, 2, f_maps=8, num_levels=3, dtype=torch.float32,
                          device="cpu", generator=torch.Generator().manual_seed(0))
    cfg = UNetConfig(in_channels=1, out_channels=2, f_maps=8, num_levels=3,
                     dtype=jnp.float32, packed=packed)
    model = UNet3DBase(config=cfg)
    x = np.random.default_rng(0).normal(size=(2, 16, 16, 16, 1)).astype(np.float32)
    variables = jax_variables(port)
    ref = np.asarray(model.apply(variables, jnp.asarray(x), train=False))

    load_jax_params(port, variables)
    with torch.inference_mode():
        y = port(torch.from_numpy(x).permute(0, 4, 1, 2, 3))
    assert y.dtype == torch.float32
    np.testing.assert_allclose(y.permute(0, 2, 3, 4, 1).numpy(), ref, atol=1e-4)


def test_full_width_state_dict_matches_jax_tree():
    """35,316,738 parameters; keys and shapes equal the converted tree."""
    model = UNet3DBase(config=UNetConfig(in_channels=1, out_channels=2))
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 16, 16, 16, 1), jnp.float32))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    converted = state_dict_from_jax(zeros)

    port = ResidualUNet3D(1, 2, device="cpu")
    assert sum(p.numel() for p in port.parameters()) == FULL_WIDTH_PARAMS
    sd = port.state_dict()
    assert sorted(sd) == sorted(converted)
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        k: tuple(v.shape) for k, v in converted.items()}
    port.load_state_dict(converted, strict=True)


def test_module_names_match_reference():
    port = ResidualUNet3D(1, 2, f_maps=4, num_levels=2, device="cpu")
    keys = set(port.state_dict())
    for k in ("encoders.0.basic_module.conv1.conv.weight",
              "encoders.1.basic_module.conv3.groupnorm.bias",
              "decoders.0.upsample.weight", "decoders.0.upsample.bias",
              "decoders.0.basic_module.conv2.groupnorm.weight",
              "final_conv.weight", "final_conv.bias"):
        assert k in keys
    assert "encoders.0.basic_module.conv1.conv.bias" not in keys  # norm after conv


def test_seeded_init_is_reproducible_and_torch_default():
    make = lambda seed: ResidualUNet3D(
        1, 2, f_maps=8, num_levels=3, device="cpu",
        generator=torch.Generator().manual_seed(seed))
    a, b, c = make(0).state_dict(), make(0).state_dict(), make(1).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["final_conv.weight"], c["final_conv.weight"])
    w = a["encoders.1.basic_module.conv2.conv.weight"]  # fan_in 16 * 27
    assert float(w.abs().max()) <= (16 * 27) ** -0.5
    up = a["decoders.0.upsample.weight"]  # (in 32, out 16, 3, 3, 3): fan_in 16*27
    assert float(up.abs().max()) <= (16 * 27) ** -0.5
    assert torch.equal(a["encoders.0.basic_module.conv1.groupnorm.weight"], torch.ones(8))


def test_divisibility_check():
    port = ResidualUNet3D(1, 2, f_maps=4, num_levels=3, device="cpu")
    with pytest.raises(ValueError, match="divisible by 4"):
        port(torch.zeros(1, 1, 8, 8, 6))


@pytest.mark.parametrize("order,match", [("rgc", "first"), ("ecg", "first"),
                                         ("cgx", "Unsupported"), ("gr", "Conv")])
def test_validate_order(order, match):
    with pytest.raises(ValueError, match=match):
        blocks.validate_order(order)


def test_group_count_and_unported_options():
    assert blocks.group_count(4, 8) == 1
    assert blocks.group_count(32, 8) == 8
    with pytest.raises(ValueError):
        blocks.group_count(12, 8)
    with pytest.raises(NotImplementedError):
        blocks.ConvLayer(4, 8, order="cbr", device="cpu")
    with pytest.raises(NotImplementedError):
        TorchUNet3DBase(TorchUNetConfig(1, 2, block="double"), device="cpu")


@pytest.mark.parametrize("order", ["cge", "cgr", "gcr", "crg"])
def test_conv_layer_orders_match_jax(order):
    """Fused (norm then act) and unfused (act then norm, norm before conv)
    plans compute the JAX ConvLayer's function."""
    from tpu_mednet.models.blocks import ConvLayer

    x = np.random.default_rng(1).normal(size=(2, 6, 6, 6, 8)).astype(np.float32)
    ref_mod = ConvLayer(out_channels=16, order=order, num_groups=4)
    v = ref_mod.init(jax.random.PRNGKey(1), jnp.asarray(x))
    ref = np.asarray(ref_mod.apply(v, jnp.asarray(x)))

    port = blocks.ConvLayer(8, 16, order=order, num_groups=4, device="cpu")
    p = _numpy_tree(v)["params"]
    sd = {"conv.weight": torch.from_numpy(p["conv"]["kernel"].transpose(4, 3, 0, 1, 2).copy())}
    if "bias" in p["conv"]:
        sd["conv.bias"] = torch.from_numpy(p["conv"]["bias"].copy())
    sd["groupnorm.weight"] = torch.from_numpy(p["groupnorm"]["scale"].copy())
    sd["groupnorm.bias"] = torch.from_numpy(p["groupnorm"]["bias"].copy())
    port.load_state_dict(sd, strict=True)
    with torch.inference_mode():
        y = port(torch.from_numpy(x).permute(0, 4, 1, 2, 3).contiguous(
            memory_format=torch.channels_last_3d))
    np.testing.assert_allclose(y.permute(0, 2, 3, 4, 1).numpy(), ref, atol=1e-4)
