"""K1's backward in the port against the JAX package, on the CPU.

``gn.group_norm`` is a ``torch.autograd.Function``; on a CPU tensor its
backward is the closed form ``group_norm_backward_plain`` (on the card the
two backward kernels, held to it in ``tests/test_torch_kernels_cuda.py``
and ``chip_smoke.py``).  Its dx, dγ, dβ and d(residual) are held here
against ``jax.vjp`` of flax ``nn.GroupNorm`` + residual + nonlinearity
(the unpacked model's chain) and of the packed chain ``packed_group_norm``
at z-block 1, whose statistics go through ``lane_moments``' custom VJP;
and against torch autograd through the plain forward.

Tolerances:
- fp32: max |port - ref| <= 1e-5 * max |ref| per output (the same
  closed form, summed in other fp32 orders);
- bf16: ||port - ref|| <= 2e-2 * ||ref|| per output (relative L2: one
  bf16 rounding of each output, and JAX's normalized value is rounded to
  bf16 before the residual add and the nonlinearity, the port's only
  after them).  Where that rounding leaves the two z's of an element with
  other signs (JAX's bf16 sum can cancel to exactly 0), the nonlinearity's
  derivative is not the same function of the inputs in the two chains:
  dy is zeroed on those elements (the tie band) for both, in bf16 only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from tpu_mednet.ops.packed import packed_group_norm
from tpu_mednet_torch.models import ResidualUNet3D
from tpu_mednet_torch.models import blocks
from tpu_mednet_torch.ops import groupnorm as gn

CL3D = torch.channels_last_3d
SHAPES = {"c16-g8": ((2, 6, 5, 4, 16), 8), "c12-g4": ((1, 4, 4, 6, 12), 4)}
_FLAX_ACT = {None: lambda v: v, "e": nn.elu, "r": nn.relu,
             "l": lambda v: nn.leaky_relu(v, negative_slope=0.1)}


def _to_port(a: np.ndarray, dtype) -> torch.Tensor:
    """(N, X, Y, Z, C) -> logical NCDHW channels_last_3d."""
    return torch.from_numpy(a).to(dtype).permute(0, 4, 1, 2, 3)


def _from_port(t: torch.Tensor) -> np.ndarray:
    return t.float().permute(0, 2, 3, 4, 1).numpy()


def _inputs(shape, seed=0, gamma=None):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    return dict(
        x=rng.normal(0.3, 1.5, size=shape).astype(np.float32),
        r=rng.normal(size=shape).astype(np.float32),
        dy=rng.normal(size=shape).astype(np.float32),
        scale=(rng.normal(1.0, 0.3, size=c) if gamma is None else gamma).astype(np.float32),
        bias=rng.normal(0.0, 0.3, size=c).astype(np.float32),
    )


def _jax_grads(inp, groups, act, residual, dtype, chain):
    """(dx, dγ, dβ, dr) of the JAX chain by ``jax.vjp``, as numpy fp32."""
    jdt = getattr(jnp, dtype)

    def f(x, scale, bias, r):
        if chain == "flax":
            y = nn.GroupNorm(num_groups=groups, epsilon=1e-5, dtype=jdt).apply(
                {"params": {"scale": scale, "bias": bias}}, x)
        else:
            y = packed_group_norm(x, 1, groups, scale, bias, 1e-5)
        if residual:
            y = y + r
        return _FLAX_ACT[act](y)

    args = (jnp.asarray(inp["x"]).astype(jdt), jnp.asarray(inp["scale"]),
            jnp.asarray(inp["bias"]), jnp.asarray(inp["r"]).astype(jdt))
    _, vjp = jax.vjp(f, *args)
    grads = vjp(jnp.asarray(inp["dy"]).astype(jdt))
    return [np.asarray(g, np.float32) for g in grads]


def _with_tie_band_zeroed(inp, groups, residual, dtype, chain="flax"):
    """bf16: ``inp`` with dy zeroed where the JAX chain's z and the port's
    fp32 z have other signs; fp32: ``inp``."""
    if dtype == "float32":
        return inp
    jdt = jnp.bfloat16
    x, r = jnp.asarray(inp["x"]).astype(jdt), jnp.asarray(inp["r"]).astype(jdt)
    if chain == "flax":
        z = nn.GroupNorm(num_groups=groups, epsilon=1e-5, dtype=jdt).apply(
            {"params": {"scale": jnp.asarray(inp["scale"]), "bias": jnp.asarray(inp["bias"])}},
            x)
    else:
        z = packed_group_norm(x, 1, groups, jnp.asarray(inp["scale"]),
                              jnp.asarray(inp["bias"]), 1e-5)
    z = np.asarray((z + r) if residual else z, np.float32)
    xt = _to_port(inp["x"], torch.bfloat16).float()
    rt = _to_port(inp["r"], torch.bfloat16).float() if residual else None
    zt = _from_port(gn.group_norm_plain(xt, groups, torch.from_numpy(inp["scale"]),
                                        torch.from_numpy(inp["bias"]), 1e-5, residual=rt))
    band = np.sign(z) != np.sign(zt)
    return {**inp, "dy": np.where(band, 0.0, inp["dy"]).astype(np.float32)}


def _port_grads(inp, groups, act, residual, dtype, fn=gn.group_norm):
    tdt = getattr(torch, dtype)
    x = _to_port(inp["x"], tdt).requires_grad_()
    r = _to_port(inp["r"], tdt).requires_grad_()
    w = torch.from_numpy(inp["scale"]).requires_grad_()
    b = torch.from_numpy(inp["bias"]).requires_grad_()
    y = fn(x, groups, w, b, 1e-5, residual=r if residual else None, act=act)
    assert y.dtype == tdt
    ins = [x, w, b] + ([r] if residual else [])
    grads = torch.autograd.grad(y, ins, _to_port(inp["dy"], tdt))
    if residual:
        assert grads[0].is_contiguous(memory_format=CL3D)
        assert grads[3].is_contiguous(memory_format=CL3D)
    out = [_from_port(grads[0]), grads[1].numpy(), grads[2].numpy()]
    return out + ([_from_port(grads[3])] if residual else [])


def _assert_close(got, ref, dtype, what):
    for name, g, r in zip(("dx", "dgamma", "dbeta", "dresidual"), got, ref):
        if dtype == "float32":
            err = float(np.abs(g - r).max())
            assert err <= 1e-5 * float(np.abs(r).max()), (what, name, err)
        else:
            rel = float(np.linalg.norm(g - r) / np.linalg.norm(r))
            assert rel <= 2e-2, (what, name, rel)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("act", [None, "e", "r", "l"])
def test_backward_matches_flax_group_norm(act, residual, shape, dtype):
    shp, groups = SHAPES[shape]
    inp = _with_tie_band_zeroed(_inputs(shp), groups, residual, dtype)
    ref = _jax_grads(inp, groups, act, residual, dtype, "flax")
    _assert_close(_port_grads(inp, groups, act, residual, dtype), ref, dtype, "flax")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("act", [None, "e", "r", "l"])
def test_backward_matches_packed_chain(act, residual, dtype):
    """``packed_group_norm`` at z-block 1: the statistics' gradient goes
    through ``lane_moments``' custom VJP (dx = g_s + 2 x g_q)."""
    shp, groups = SHAPES["c16-g8"]
    inp = _with_tie_band_zeroed(_inputs(shp, seed=1), groups, residual, dtype, "packed")
    ref = _jax_grads(inp, groups, act, residual, dtype, "packed")
    _assert_close(_port_grads(inp, groups, act, residual, dtype), ref, dtype, "packed")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("act", [None, "e", "r", "l"])
def test_closed_form_matches_autograd_of_plain_forward(act, residual, dtype):
    shp, groups = SHAPES["c12-g4"]
    inp = _inputs(shp, seed=2)
    got = _port_grads(inp, groups, act, residual, dtype)
    ref = _port_grads(inp, groups, act, residual, dtype, fn=gn.group_norm_plain)
    _assert_close(got, ref, dtype, "autograd")


def test_backward_where_gamma_is_zero():
    """γ = 0 on a whole group and on one channel of another: mul = rstd·γ
    is 0 there, yet dγ = Σ dz·x̂ needs rstd, which the statistics keep."""
    shp, groups = SHAPES["c16-g8"]
    gamma = np.random.default_rng(3).normal(1.0, 0.3, size=shp[-1])
    gamma[:2] = 0.0  # group 0
    gamma[5] = 0.0   # one channel of group 2
    inp = _inputs(shp, seed=3, gamma=gamma)
    for residual in (False, True):
        ref = _jax_grads(inp, groups, "e", residual, "float32", "flax")
        got = _port_grads(inp, groups, "e", residual, "float32")
        _assert_close(got, ref, "float32", "gamma=0")
        assert np.all(got[1][:2] != 0) and got[1][5] != 0  # dγ where γ = 0
        assert np.all(got[0][..., :2] == 0)  # no path from x through γ = 0


def test_backward_plain_validates_act():
    x = torch.zeros((1, 4, 2, 2, 2)).contiguous(memory_format=CL3D)
    stats = gn.group_norm_moments(x, 2, torch.ones(4))
    with pytest.raises(ValueError, match="nonlinearity"):
        gn.group_norm_backward(x, x, stats.mean, stats.rstd, torch.ones(4),
                               torch.zeros(4), 2, act="x")


def _no_grad_kernel_stand_ins(monkeypatch):
    """Stand-ins for the CUDA wrappers: the plain values, but with no
    autograd history, as a kernel's output has none."""
    moments, apply = gn.group_norm_moments, gn.group_norm_apply

    def wrap(fn):
        def run(*args, **kwargs):
            with torch.no_grad():
                return fn(*args, **kwargs)
        return run

    monkeypatch.setattr(gn, "group_norm_moments", wrap(moments))
    monkeypatch.setattr(gn, "group_norm_apply", wrap(apply))


def _model_grads(model, x, label):
    model.zero_grad(set_to_none=True)
    logits = model(x)
    loss = torch.nn.functional.cross_entropy(logits, label)
    loss.backward()
    return {k: p.grad for k, p in model.named_parameters()}


def test_every_parameter_gets_the_autograd_gradient_through_kernel_outputs(monkeypatch):
    """Every GroupNorm of the model runs through the autograd Function: with
    forward kernels whose outputs carry no autograd history (as on the
    card), every parameter still receives a gradient, equal to torch
    autograd's through the plain forward (fp32 atol 1e-5 * max |g|: the
    same gradient, summed in another order)."""
    model = ResidualUNet3D(1, 2, f_maps=8, num_levels=3, dtype=torch.float32,
                           device="cpu", generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(2, 1, 16, 16, 16)).astype(np.float32))
    label = torch.from_numpy(rng.integers(0, 2, size=(2, 16, 16, 16)))
    def plain(x, groups, w, b, eps, residual=None, act=None, slope=gn.LEAKY_SLOPE):
        mean_c, mul_c = gn.group_norm_moments_plain(x, groups, w, eps)[:2]
        return gn.group_norm_apply_plain(x, mean_c, mul_c, b, residual, act, slope)

    with monkeypatch.context() as m:
        m.setattr(blocks.gn, "group_norm", plain)
        ref = _model_grads(model, x, label)
    _no_grad_kernel_stand_ins(monkeypatch)
    got = _model_grads(model, x, label)
    assert sorted(got) == sorted(ref)
    for k, g in got.items():
        assert g is not None and bool(g.abs().max() > 0), k
        scale = float(ref[k].abs().max())
        assert float((g - ref[k]).abs().max()) <= 1e-5 * scale, k
