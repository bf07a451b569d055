"""The port's kernel modules against the JAX package, on the CPU.

On a CPU tensor each kernel wrapper of ``tpu_mednet_torch.ops`` runs its
plain PyTorch version; those are held here against the JAX package's XLA
path and its Pallas kernels in interpret mode.  The CUDA kernels themselves
are held against the same plain versions on the card
(``tests/test_torch_kernels_cuda.py`` and ``chip_smoke.py``).

Tolerances: fp32 moments rtol 1e-5 (same sums, another summation order; the
inputs have a nonzero mean so no channel sum cancels to ~0); GroupNorm
outputs atol 1e-5 in fp32 (same formula, another reduction order for the
statistics); window gathers byte-equal (pure data movement).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from tpu_mednet.ops.packed import packed_group_norm_stats
from tpu_mednet.ops.pallas.groupnorm import _lane_moments_xla, lane_moments_pallas
from tpu_mednet.ops.pallas.patches import extract_patches_pallas, extract_patches_xla
from tpu_mednet_torch.ops import groupnorm as gn
from tpu_mednet_torch.ops import patches as P

CL3D = torch.channels_last_3d


def _to_port(x_nxyzc: np.ndarray, dtype=torch.float32) -> torch.Tensor:
    """JAX layout (N, X, Y, Z, C) -> logical NCDHW channels_last_3d."""
    return torch.from_numpy(x_nxyzc).to(dtype).permute(0, 4, 1, 2, 3)


def _from_port(t: torch.Tensor) -> np.ndarray:
    return t.float().permute(0, 2, 3, 4, 1).numpy()


# -- K1: statistics ---------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 8, 6, 4, 128), (1, 12, 4, 3, 256)])
def test_gn_stats_plain_matches_xla_and_pallas(shape, dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(0.5, 1.0, size=shape).astype(np.float32)
    xj = jnp.asarray(x).astype(getattr(jnp, dtype))
    xt = _to_port(x, getattr(torch, dtype))
    assert xt.is_contiguous(memory_format=CL3D)
    s, q = gn.group_norm_stats_plain(xt)
    for s_ref, q_ref in (_lane_moments_xla(xj), lane_moments_pallas(xj, interpret=True)):
        np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), rtol=1e-5)
        np.testing.assert_allclose(q.numpy(), np.asarray(q_ref), rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,groups", [((2, 8, 6, 4, 64), 8), ((3, 5, 4, 6, 24), 4)])
def test_group_norm_moments_matches_jax_fold(shape, groups, dtype):
    """mean_c, rstd_c = rsqrt(var + eps) and mul_c = rstd_c * gamma against
    the JAX package's moments and group fold (``packed_group_norm_stats``, one z-slice)."""
    rng = np.random.default_rng(5)
    x = rng.normal(0.5, 1.0, size=shape).astype(np.float32)
    gamma = rng.normal(1.0, 0.2, size=shape[-1]).astype(np.float32)
    mean, var = packed_group_norm_stats(jnp.asarray(x).astype(getattr(jnp, dtype)), 1, groups)
    cg = shape[-1] // groups
    mean_ref = np.repeat(np.asarray(mean), cg, axis=1)
    rstd_ref = np.repeat(np.asarray(jax.lax.rsqrt(jnp.maximum(var, 0.0) + 1e-5)), cg, axis=1)
    mean_c, mul_c, rstd_c = gn.group_norm_moments(_to_port(x, getattr(torch, dtype)), groups,
                                                  torch.from_numpy(gamma), 1e-5)
    assert mean_c.dtype == mul_c.dtype == rstd_c.dtype == torch.float32
    np.testing.assert_allclose(mean_c.numpy(), mean_ref, rtol=1e-5)
    np.testing.assert_allclose(mul_c.numpy(), rstd_ref * gamma, rtol=1e-5)
    np.testing.assert_allclose(rstd_c.numpy(), rstd_ref, rtol=1e-5)


# the main path's five GroupNorm shapes, bf16, on a 132-SM card:
# (N, S, C) -> (blocks per sample, rows per block, rows per bulk-copy stage)
_LEVEL_PLANS = [((8, 96**3, 32), (33, 26811, 256)), ((8, 48**3, 64), (33, 3352, 128)),
                ((8, 24**3, 128), (33, 419, 64)), ((8, 12**3, 256), (14, 124, 32)),
                ((8, 6**3, 512), (4, 54, 16))]


@pytest.mark.parametrize("shape,expected", _LEVEL_PLANS)
def test_plan_moments_at_the_main_path_shapes(shape, expected):
    n, s, c = shape
    plan = gn.plan_moments(n, s, c, 2, True, 132)
    assert plan == gn.MomentsPlan(True, *expected)
    assert plan.stage_rows * c * 2 == gn._STAGE_BYTES


@pytest.mark.parametrize("n,s,c,esize,aligned,bulk", [
    (2, 210, 12, 2, True, False),      # 24-byte rows: no bulk copies
    (2, 210, 12, 4, True, True),       # 48-byte rows
    (2, 120, 32, 2, False, False),     # unaligned base
    (1, 64, 4096, 2, True, False),     # 512 vectors per row: too wide for a consumer each
    (3, 6, 32, 4, True, True),         # S below one block
    (1, 10**6, 8, 4, True, True),      # one sample: the whole card's blocks
])
def test_plan_moments_routes_and_covers_every_row(n, s, c, esize, aligned, bulk):
    plan = gn.plan_moments(n, s, c, esize, aligned, 132)
    assert plan.bulk == bulk
    assert plan.stage_rows == (gn._STAGE_BYTES // (c * esize) if bulk else 0)
    # every row in exactly one block, no block empty
    assert plan.blocks * plan.rows_per_block >= s > (plan.blocks - 1) * plan.rows_per_block
    assert plan.blocks <= max(1, -(-gn._BLOCKS_PER_SM * 132 // n))
    if plan.blocks > 1:
        assert s * c * esize >= (plan.blocks - 1) * gn._MIN_BLOCK_BYTES


# -- K1: normalize + affine (+ residual) (+ act) ---------------------------

_FLAX_ACT = {None: lambda v: v, "e": nn.elu, "r": nn.relu,
             "l": lambda v: nn.leaky_relu(v, negative_slope=0.1)}


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("act", [None, "e", "r", "l"])
@pytest.mark.parametrize("shape,groups", [((2, 6, 5, 4, 32), 8), ((1, 4, 4, 6, 16), 4)])
def test_group_norm_plain_matches_flax(shape, groups, act, residual):
    rng = np.random.default_rng(1)
    x = rng.normal(0.3, 1.5, size=shape).astype(np.float32)
    r = rng.normal(size=shape).astype(np.float32)
    c = shape[-1]
    scale = rng.normal(1.0, 0.2, size=c).astype(np.float32)
    bias = rng.normal(0.0, 0.2, size=c).astype(np.float32)

    mod = nn.GroupNorm(num_groups=groups, epsilon=1e-5)
    params = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}}
    ref = mod.apply(params, jnp.asarray(x))
    if residual:
        ref = ref + jnp.asarray(r)
    ref = np.asarray(_FLAX_ACT[act](ref))

    y = gn.group_norm(_to_port(x), groups, torch.from_numpy(scale),
                      torch.from_numpy(bias), eps=1e-5,
                      residual=_to_port(r) if residual else None, act=act)
    assert y.is_contiguous(memory_format=CL3D)
    np.testing.assert_allclose(_from_port(y), ref, atol=1e-5)


def test_group_norm_plain_bf16_rounds_once():
    """bf16 in, bf16 out: the fp32 result rounded once to bf16."""
    rng = np.random.default_rng(2)
    x = _to_port(rng.normal(size=(2, 4, 4, 4, 16)).astype(np.float32), torch.bfloat16)
    w, b = torch.ones(16), torch.zeros(16)
    y = gn.group_norm(x, 4, w, b, act="e")
    assert y.dtype == torch.bfloat16
    ref = gn.group_norm(x.float().contiguous(memory_format=CL3D), 4, w, b, act="e")
    np.testing.assert_array_equal(y.float().numpy(), ref.to(torch.bfloat16).float().numpy())


def test_group_norm_rejects_other_devices_and_bad_groups():
    x = torch.zeros((1, 8, 2, 2, 2), device="meta").contiguous(memory_format=CL3D)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        gn.group_norm_moments(x, 4, torch.ones(8), 1e-5)
    with pytest.raises(ValueError, match="divisible"):
        gn.group_norm(torch.zeros(1, 6, 2, 2, 2), 4, torch.ones(6), torch.zeros(6))
    with pytest.raises(ValueError, match="nonlinearity"):
        gn.group_norm(torch.zeros(1, 8, 2, 2, 2), 4, torch.ones(8), torch.zeros(8), act="x")


# -- K2: window gather ------------------------------------------------------

@pytest.mark.parametrize("c", [1, 128])
def test_extract_patches_plain_matches_xla_and_pallas(c):
    rng = np.random.default_rng(3)
    vol = rng.normal(size=(20, 18, 22, c)).astype(np.float16)
    patch = (8, 6, 10)
    corners = np.stack([rng.integers(0, s - p + 1, size=5)
                        for s, p in zip(vol.shape[:3], patch)], axis=-1).astype(np.int32)
    corners[0] = 0
    corners[1] = np.asarray(vol.shape[:3]) - np.asarray(patch)
    got = P.extract_patches(torch.from_numpy(vol), corners, patch).numpy()
    for ref in (extract_patches_xla(jnp.asarray(vol), jnp.asarray(corners), patch),
                extract_patches_pallas(jnp.asarray(vol), jnp.asarray(corners), patch,
                                       interpret=True)):
        ref = np.asarray(ref)
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got.view(np.uint16), ref.view(np.uint16))


@pytest.mark.parametrize("out_dtype", ["bfloat16", "float32"])
def test_extract_patches_fuses_cast(out_dtype):
    rng = np.random.default_rng(4)
    vol = torch.from_numpy(rng.normal(size=(12, 12, 12, 1)).astype(np.float16))
    corners = np.array([[0, 2, 4], [4, 4, 4]], np.int32)
    got = P.extract_patches(vol, corners, (8, 8, 8), out_dtype=getattr(torch, out_dtype))
    ref = P.extract_patches(vol, corners, (8, 8, 8)).to(getattr(torch, out_dtype))
    assert got.dtype == ref.dtype
    assert torch.equal(got, ref)


@pytest.mark.parametrize("corners,match", [
    (np.array([[0, 0, 5]], np.int32), "leave the volume"),
    (np.array([[-1, 0, 0]], np.int32), "leave the volume"),
    (np.array([[0, 0]], np.int32), r"\(N, 3\)"),
    (np.array([[0.0, 0.0, 0.0]]), r"\(N, 3\)"),
])
def test_extract_patches_validates_corners(corners, match):
    vol = torch.zeros((8, 8, 8, 1), dtype=torch.float16)
    with pytest.raises(ValueError, match=match):
        P.extract_patches(vol, corners, (4, 4, 4))


def test_extract_patches_indexed_by_subject():
    """With ``subjects``, window i comes from ``store[subjects[i]]``: the
    same bytes as a gather from that one volume; uint8 stores are copied."""
    rng = np.random.default_rng(5)
    store = torch.from_numpy(rng.integers(0, 255, size=(3, 12, 10, 14, 2)).astype(np.uint8))
    corners = np.array([[0, 1, 2], [4, 4, 4], [2, 0, 6], [4, 2, 0]], np.int32)
    subjects = np.array([2, 0, 2, 1], np.int32)
    got = P.extract_patches(store, corners, (8, 6, 8), subjects=subjects)
    assert got.dtype == torch.uint8 and got.shape == (4, 8, 6, 8, 2)
    for i, (c, s) in enumerate(zip(corners, subjects)):
        assert torch.equal(got[i], P.extract_patches(store[s], c[None], (8, 6, 8))[0])


@pytest.mark.parametrize("subjects,match", [
    (np.array([0, 3], np.int32), "leave the store"),
    (np.array([-1, 0], np.int32), "leave the store"),
    (np.array([0], np.int32), r"subjects must be \(2,\)"),
    (np.array([0.0, 1.0]), "integers"),
])
def test_extract_patches_validates_subjects(subjects, match):
    store = torch.zeros((3, 8, 8, 8, 1), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=match):
        P.extract_patches(store, np.zeros((2, 3), np.int32), (4, 4, 4), subjects=subjects)


def test_extract_patches_refuses_uint8_casts_and_store_without_subjects():
    vol = torch.zeros((8, 8, 8, 1), dtype=torch.uint8)
    with pytest.raises(ValueError, match="only copied"):
        P.extract_patches(vol, np.zeros((1, 3), np.int32), (4, 4, 4), out_dtype=torch.float32)
    with pytest.raises(ValueError, match="only copied"):
        P.extract_patches(vol.float(), np.zeros((1, 3), np.int32), (4, 4, 4),
                          out_dtype=torch.uint8)
    with pytest.raises(ValueError, match=r"\(X, Y, Z, C\)"):
        P.extract_patches(vol[None], np.zeros((1, 3), np.int32), (4, 4, 4))


# -- kernel build -------------------------------------------------------------

def test_library_is_named_by_its_sources(tmp_path, monkeypatch):
    from tpu_mednet_torch.ops import _build

    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    (tmp_path / "a.cu").write_text("// a\n")
    (tmp_path / "h.cuh").write_text("// h\n")
    first = _build.library_path()
    assert first.parent == tmp_path / "build" and first.suffix == ".so"
    assert _build.library_path() == first
    (tmp_path / "h.cuh").write_text("// h, edited\n")
    assert _build.library_path() != first


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    import shutil
    from pathlib import Path

    from tpu_mednet_torch.ops import _build

    if Path("/usr/local/cuda/bin/nvcc").is_file():
        pytest.skip("this host has nvcc")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.delenv("CUDA_HOME", raising=False)
    (tmp_path / "a.cu").write_text("// a\n")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
