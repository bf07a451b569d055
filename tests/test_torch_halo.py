"""The port's halo exchange and slab GroupNorm against the JAX package's, on the CPU.

The JAX package splits X over a mesh's ``space`` axis and moves boundary
rows with ``ppermute`` (``tpu_mednet/parallel/halo.py``); the port runs one
gloo rank per slab and sends them point to point
(``tpu_mednet_torch/parallel/halo.py``).  The ranks here are four gloo
processes on the CPU started by the port's own launcher
(``tests/torch_sp_ranks.py``) with a hard timeout (``RANK_TIMEOUT``: killed,
and the test failed); the JAX side runs in this process on the 8 virtual
CPU devices.

Tolerances: the halo cases 1e-5 × max |ref| against JAX's sharded result
(another convolution's summation order) and JAX's negative control (a
halo below the reach differs by more than atol 1e-4); rows moved between
slabs exact (copies); a gradient through the exchange 1e-5 × max |ref|
against autograd of the padded volume; GroupNorm over 2 and 4 slabs
forward and backward 1e-5 × max |ref| against flax's on the whole tensor
(K1's CPU bound, ROADMAP's "Tolerances on record"); the losses over slabs
and their gradients rtol 1e-6, atol 1e-6 against JAX's on the global
batch (the loss tests' own; a slab's gradient is the mesh size times
JAX's, the autograd all-reduce's backward sums), the landmark coordinate
error over slabs equal to one process's to 1e-6; the transposed and 3^3
convolutions at every split point 1e-6 × max |ref| against the unsplit op.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import linen as fnn

from tests.test_torch_parallel import run_ranks
from tpu_mednet.ops import losses as JL
from tpu_mednet.parallel.halo import spatially_sharded_apply as jax_apply
from tpu_mednet.parallel.mesh import make_mesh as jax_make_mesh
from tpu_mednet.parallel.mesh import spatial_sharding
from tpu_mednet_torch.models import blocks
from tpu_mednet_torch.parallel import mesh as port_mesh
from tpu_mednet_torch.tasks.landmarks import landmark_coordinate_error

WORLD = 4
CL3D = torch.channels_last_3d


def _rel(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max()) / max(float(np.abs(want).max()), 1e-30)


def _cf(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 4, 1, 2, 3)


def _cl(a: torch.Tensor) -> np.ndarray:
    return a.permute(0, 2, 3, 4, 1).numpy()


def _conv_jax(w):
    def conv(v):
        return jax.lax.conv_general_dilated(
            v, jnp.asarray(w), window_strides=(1, 1, 1), padding="SAME",
            dimension_numbers=("NDHWC", "DHWIO", "NDHWC"))
    return conv


def _w_torch(w: np.ndarray) -> torch.Tensor:
    """DHWIO -> (O, I, D, H, W)."""
    return torch.from_numpy(np.ascontiguousarray(w.transpose(4, 3, 0, 1, 2)))


def _cases():
    """``tests/test_halo.py``'s inputs, drawn as it draws them."""
    x_id = np.random.default_rng(0).normal(size=(1, 64, 8, 8, 1)).astype(np.float32)
    rng = np.random.default_rng(1)
    x1 = rng.normal(size=(1, 64, 8, 8, 2)).astype(np.float32)
    w1 = rng.normal(size=(3, 3, 3, 2, 4)).astype(np.float32) * 0.1
    rng = np.random.default_rng(2)
    x2 = rng.normal(size=(1, 64, 8, 8, 1)).astype(np.float32)
    w2 = rng.normal(size=(3, 3, 3, 1, 1)).astype(np.float32)
    return x_id, x1, w1, x2, w2


GN_SHAPE = (2, 16, 4, 4, 8)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    root = tmp_path_factory.mktemp("halo")
    x_id, x1, w1, x2, w2 = _cases()
    rng = np.random.default_rng(9)
    g1 = rng.normal(size=(1, 4, 64, 8, 8)).astype(np.float32)
    lengths, off = (24, 8, 16, 16), (0, 24, 32, 48)
    g_far = [torch.from_numpy(rng.normal(size=(1, 2, n + 24, 8, 8)).astype(np.float32))
             for n in lengths]
    gn = {k: rng.normal(size=GN_SHAPE).astype(np.float32) for k in ("x", "r", "dy")}
    gn["x"] = gn["x"] * 2.0 + 0.5
    gn_w = rng.normal(size=8).astype(np.float32)
    gn_b = rng.normal(size=8).astype(np.float32)
    inputs = {"x_id": _cf(x_id), "x1": _cf(x1), "w1": _w_torch(w1), "x2": _cf(x2),
              "w2": _w_torch(w2), "g1": torch.from_numpy(g1), "g_far": g_far,
              **{f"gn_{k}": _cf(v) for k, v in gn.items()},
              "gn_w": torch.from_numpy(gn_w), "gn_b": torch.from_numpy(gn_b)}
    lrng = np.random.default_rng(7)
    lshape = (4, 8, 8, 8)
    losses = dict(logits=lrng.normal(size=(4, 3, *lshape[1:])).astype(np.float32),
                  logits_ldmk=lrng.normal(scale=3.0, size=(4, 6, *lshape[1:])).astype(
                      np.float32),
                  labels=lrng.integers(0, 3, size=lshape).astype(np.int64),
                  heatmaps=lrng.uniform(0, 255, size=(4, 3, *lshape[1:])).astype(np.float32))
    losses["heatmaps"][1, 2] = 0.0  # a landmark outside its patch: left out of the mean
    inputs.update({k: torch.from_numpy(v) for k, v in losses.items()})
    (root / "spec.json").write_text(json.dumps({"jobs": ["halo", "gn", "losses"]}))
    torch.save(inputs, root / "inputs.pt")
    run_ranks(root, "tests.torch_sp_ranks", [str(root)], nprocs=WORLD)
    outs = [torch.load(root / f"rank{r}.pt") for r in range(WORLD)]
    return dict(outs=outs, inputs=inputs, lengths=lengths, off=off, gn=gn, gn_w=gn_w,
                gn_b=gn_b, losses=losses)


def _whole(outs, job, key):
    """The 1 x 4 mesh's slabs put together along X, as JAX's layout."""
    return _cl(torch.cat([o[job][key] for o in outs], dim=2))


# -- (a) the exchange against JAX's ---------------------------------------------


@pytest.mark.parametrize("case", ["identity", "single", "stacked"])
def test_halo_cases_equal_jax(ranks, case):
    x_id, x1, w1, x2, w2 = _cases()
    mesh = jax_make_mesh(n_data=1, n_space=8)
    conv2 = _conv_jax(w2)
    fn, x, halo = {"identity": (lambda v: v, x_id, 2), "single": (_conv_jax(w1), x1, 1),
                   "stacked": (lambda v: conv2(conv2(v)), x2, 2)}[case]
    xs = jax.device_put(x, spatial_sharding(mesh, axis=1))
    want = np.asarray(jax.jit(jax_apply(fn, mesh, halo=halo))(xs))
    got = _whole(ranks["outs"], "halo", case)
    assert got.shape == want.shape
    assert _rel(got, want) <= 1e-5, case
    if case == "stacked":
        # JAX's negative control: a halo of 1 cannot cover two convolutions
        xp = np.pad(x, [(0, 0), (1, 1), (0, 0), (0, 0), (0, 0)])
        ref1 = np.asarray(fn(jnp.asarray(xp)))[:, 1:-1]
        small = _whole(ranks["outs"], "halo", "stacked_small")
        assert not np.allclose(small, ref1, atol=1e-4)


def test_gradient_through_the_exchange_equals_the_padded_volume(ranks):
    inp = ranks["inputs"]
    x = inp["x1"].clone().requires_grad_(True)
    y = F.conv3d(F.pad(x, (0, 0, 0, 0, 1, 1)), inp["w1"], padding=1)[:, :, 1:-1]
    (y * inp["g1"]).sum().backward()
    got = torch.cat([o["halo"]["grad"] for o in ranks["outs"]], dim=2)
    assert _rel(got.numpy(), x.grad.numpy()) <= 1e-5


def test_rows_of_uneven_slabs_past_the_next_rank_and_mirrored(ranks):
    """A halo of 12 over slabs of (24, 8, 16, 16) reaches two ranks away;
    the mirror and arbitrary ranges come from whichever slabs hold them;
    the exchange's backward adds every moved row's gradient into its
    owner's row."""
    x = ranks["inputs"]["x1"]
    lengths, off = ranks["lengths"], ranks["off"]
    padded = F.pad(x, (0, 0, 0, 0, 12, 12))
    wide = F.pad(x, (0, 0, 0, 0, 3, 6))
    wants = [(-3, 70), (0, 64), (60, 66), (5, 9)]
    grad = torch.zeros_like(padded)
    for s, out in enumerate(ranks["outs"]):
        a, n = off[s], lengths[s]
        assert torch.equal(out["halo"]["far"], padded[:, :, a:a + n + 24]), s
        grad[:, :, a:a + n + 24] += ranks["inputs"]["g_far"][s]
        assert torch.equal(out["halo"]["mirror"], torch.flip(x, (2,))[:, :, a:a + n]), s
        lo, hi = wants[s]
        assert torch.equal(out["halo"]["wide"], wide[:, :, lo + 3:hi + 3]), s
    for s, out in enumerate(ranks["outs"]):
        a, n = off[s], lengths[s]
        torch.testing.assert_close(out["halo"]["far_grad"], grad[:, :, 12 + a:12 + a + n],
                                   rtol=0, atol=1e-6)


# -- (b) the slab plan, and the convolutions at every split point -----------------


@pytest.mark.parametrize("extent,n,q,want", [
    (96, 4, 16, (32, 32, 16, 16)), (128, 2, 16, (64, 64)), (64, 8, 2, (8,) * 8),
    (56, 8, 2, (8, 8, 8, 8, 6, 6, 6, 6)), (48, 2, 16, (32, 16)), (7, 3, 1, (3, 2, 2))])
def test_slab_plan_splits(extent, n, q, want):
    plan = port_mesh.slab_plan(extent, n, q)
    assert plan.lengths == want and sum(plan.lengths) == extent
    assert plan.offsets == tuple(sum(want[:s]) for s in range(n))
    assert [plan.slab(s) for s in range(n)] == [slice(plan.offsets[s], plan.offsets[s] + want[s])
                                                for s in range(n)]


@pytest.mark.parametrize("extent,n,q,match", [
    (50, 2, 16, "not a multiple of the pooling factor 16"),
    (16, 2, 16, "cannot give each of 2 ranks a slab of at least the pooling factor 16")])
def test_slab_plan_refusals(extent, n, q, match):
    with pytest.raises(ValueError, match=match):
        port_mesh.slab_plan(extent, n, q)


class _WholeVolume:
    """A stand-in space axis of two slabs split at ``k`` that takes its
    halo rows from the whole tensor: the layers' arithmetic alone."""

    def __init__(self, whole, k, scale=1):
        self.whole, self.k, self.scale = whole, k, scale
        self.slab = 0

    def exchange(self, x, lo, hi):
        k = self.k // self.scale
        a, b = (0, k) if self.slab == 0 else (k, self.whole.shape[2])
        padded = F.pad(self.whole, (0, 0, 0, 0, lo, hi))
        return padded[:, :, a:b + lo + hi].contiguous(memory_format=CL3D)


@pytest.mark.parametrize("k", range(1, 8))
def test_transposed_conv_at_every_split_point(k):
    """The decoder's ConvTranspose3d(k3, s2, p1, op1) on a split input:
    each slab takes its right neighbour's first row and crops one output
    row, and the halves put together equal the unsplit op."""
    torch.manual_seed(k)
    stage = blocks.DecoderStage(4, 2, block="residual", num_groups=1, dtype=torch.float32,
                                device="cpu")
    x = torch.randn(2, 4, 8, 3, 5).contiguous(memory_format=CL3D)
    skip = torch.zeros(2, 2, 16, 6, 10).contiguous(memory_format=CL3D)
    up = stage.upsample
    want = F.conv_transpose3d(x, up.weight, up.bias, stride=2, padding=1, output_padding=1)
    stage.basic_module = torch.nn.Identity()
    space = _WholeVolume(x, k)
    stage.space = space
    parts = []
    for s, rows in enumerate((slice(0, k), slice(k, 8))):
        space.slab = s
        parts.append(stage(skip[:, :, 2 * rows.start:2 * rows.stop], x[:, :, rows].contiguous(
            memory_format=CL3D)))
    got = torch.cat(parts, dim=2)
    assert got.shape == want.shape
    assert _rel(got.detach().numpy(), want.detach().numpy()) <= 1e-6


@pytest.mark.parametrize("k", range(1, 8))
def test_conv_layer_at_every_split_point(k):
    torch.manual_seed(10 + k)
    layer = blocks.ConvLayer(3, 4, order="cr", dtype=torch.float32, device="cpu")
    x = torch.randn(2, 3, 8, 5, 4).contiguous(memory_format=CL3D)
    want = layer(x)
    space = _WholeVolume(x, k)
    layer.space = space
    parts = []
    for s, rows in enumerate((slice(0, k), slice(k, 8))):
        space.slab = s
        parts.append(layer(x[:, :, rows].contiguous(memory_format=CL3D)))
    got = torch.cat(parts, dim=2)
    assert _rel(got.detach().numpy(), want.detach().numpy()) <= 1e-6


# -- (c) GroupNorm over slabs against flax's on the whole tensor -------------------


@pytest.mark.parametrize("mesh_name", ["1x4", "2x2"])
def test_slab_group_norm_equals_flax(ranks, mesh_name):
    gn, w, b = ranks["gn"], ranks["gn_w"], ranks["gn_b"]
    module = fnn.GroupNorm(num_groups=2, epsilon=1e-5)
    params = {"params": {"scale": jnp.asarray(w), "bias": jnp.asarray(b)}}

    def fwd(p, x, r):
        return jax.nn.elu(module.apply(p, x) + r)

    y, vjp = jax.vjp(fwd, params, jnp.asarray(gn["x"]), jnp.asarray(gn["r"]))
    dp, dx, dr = vjp(jnp.asarray(gn["dy"]))
    outs = [o["gn"][mesh_name] for o in ranks["outs"]]
    n_space = 4 if mesh_name == "1x4" else 2
    # rank d * n_space + s holds rows of data index d, slab s
    got = {}
    for key in ("y", "dx", "dr"):
        rows = [torch.cat([outs[d * n_space + s][key] for s in range(n_space)], dim=2)
                for d in range(WORLD // n_space)]
        got[key] = _cl(torch.cat(rows, dim=0))
    for key, want in (("y", y), ("dx", dx), ("dr", dr)):
        assert _rel(got[key], want) <= 1e-5, key
    # the differentiable sum over a data row: ranks d * n_space + s hold r + 1
    for r, o in enumerate(outs):
        row = range(r // n_space * n_space, (r // n_space + 1) * n_space)
        assert torch.equal(o["space_sum"], torch.full((3,), float(sum(q + 1 for q in row))))
        assert torch.equal(o["space_sum_grad"], n_space * torch.arange(3.0))
    dw = sum(o["dw"] for o in outs).numpy()
    db = sum(o["db"] for o in outs).numpy()
    assert _rel(dw, dp["params"]["scale"]) <= 1e-5
    assert _rel(db, dp["params"]["bias"]) <= 1e-5


# -- the losses' sums and counts over slabs and rows -------------------------------


def _jax_loss_cases():
    onehot = lambda y: JL.expand_as_one_hot(y, 3)
    reg_w = [0.015, 0.001, 0.02]
    return {
        "dice": lambda z, y, hm: JL.dice_loss(z, y),
        "ce_weighted": lambda z, y, hm: JL.ce_loss(z, y, weight=jnp.asarray([0.3, 1.0, 2.0])),
        "wce": lambda z, y, hm: JL.weighted_ce_loss(z, onehot(y)),
        "landmark": lambda z, y, hm: JL.multitask_landmark_loss(
            z[..., 3:], z[..., :3], y, hm, reg_w)[0],
        "landmark_ce_l1": lambda z, y, hm: JL.multitask_landmark_loss(
            z[..., 3:], z[..., :3], y, hm, reg_w, class_loss="CE", regression_loss="L1")[0],
    }


@pytest.mark.parametrize("mesh_name", ["1x4", "2x2"])
@pytest.mark.parametrize("name", list(_jax_loss_cases()))
def test_losses_over_slabs_equal_jax_on_the_global_batch(ranks, name, mesh_name):
    li = ranks["losses"]
    z = li["logits_ldmk" if name.startswith("landmark") else "logits"]
    hm = np.moveaxis(li["heatmaps"], 1, -1)
    loss, grad = jax.value_and_grad(lambda zz: _jax_loss_cases()[name](
        zz, jnp.asarray(li["labels"]), jnp.asarray(hm)))(jnp.asarray(np.moveaxis(z, 1, -1)))
    grad = np.moveaxis(np.asarray(grad), -1, 1)
    n_space = 4 if mesh_name == "1x4" else 2
    parts = []
    for d in range(WORLD // n_space):
        row = []
        for s in range(n_space):
            got_loss, got_grad = ranks["outs"][d * n_space + s]["losses"][mesh_name][name]
            np.testing.assert_allclose(float(got_loss), float(loss), rtol=1e-6, atol=1e-6)
            row.append(got_grad / WORLD)
        parts.append(torch.cat(row, dim=2))
    np.testing.assert_allclose(torch.cat(parts).numpy(), grad, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("mesh_name", ["1x4", "2x2"])
def test_landmark_coordinate_error_over_slabs_equals_one_process(ranks, mesh_name):
    li = ranks["losses"]
    want = landmark_coordinate_error(torch.from_numpy(li["logits_ldmk"][:, :3]),
                                     torch.from_numpy(li["heatmaps"]))
    for out in ranks["outs"]:
        got = out["losses"][mesh_name]["coordinate_error"]
        assert abs(float(got) - float(want)) <= 1e-6 * max(1.0, float(want))
