"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda`` and skipped where ``torch.cuda.is_available()`` is false.
This file imports neither JAX nor tpu_mednet, so it also runs on a machine
without them, skipping the JAX test setup:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Tolerances: moments rtol 1e-5 (another fp32 summation order); the fused
apply atol 1e-5 in fp32 and within one bf16 ulp in bf16 (one rounding of
nearly the same fp32 value); the backward's dγ, dβ within 1e-4 * max |ref|
(per-(n, c) sums of another fp32 order), dx and d(residual) within
1e-5 * max |ref| in fp32 and, in bf16, one bf16 ulp of the plain value
plus 1e-5 * max |ref| (the same elementwise arithmetic on coefficients
that differ by their sums' order, rounded once); gathers byte-equal.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from tpu_mednet_torch.ops import groupnorm as gn
from tpu_mednet_torch.ops import patches as P

CL3D = torch.channels_last_3d


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _activation(shape, dtype, device, seed, offset=0):
    """(N, C, D, H, W) channels_last_3d; ``offset`` elements into its storage."""
    g = torch.Generator().manual_seed(seed)
    n, c, *sp = shape
    flat = (torch.randn(offset + n * c * int(np.prod(sp)), generator=g) + 0.5).to(dtype)
    x = flat.to(device)[offset:].view(n, *sp, c).permute(0, 4, 1, 2, 3)
    assert x.is_contiguous(memory_format=CL3D)
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gn_kernels_match_plain_on_card(cuda_device, dtype):
    g = torch.Generator().manual_seed(5)
    x = (torch.randn((2, 64, 6, 10, 12), generator=g) + 0.5).to(dtype)
    x = x.to(cuda_device).contiguous(memory_format=CL3D)
    r = torch.randn((2, 64, 6, 10, 12), generator=g).to(dtype).to(cuda_device)
    r = r.contiguous(memory_format=CL3D)
    w = torch.rand(64, generator=g).to(cuda_device)
    b = torch.rand(64, generator=g).to(cuda_device)
    stats = gn.group_norm_moments(x, 8, w, 1e-5)
    mean_p, mul_p, rstd_p = gn.group_norm_moments_plain(x, 8, w, 1e-5)
    for got, ref in zip(stats, (mean_p, mul_p, rstd_p)):
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=0)
    y = gn.group_norm_apply(x, mean_p, mul_p, b, residual=r, act="e")
    y_p = gn.group_norm_apply_plain(x, mean_p, mul_p, b, residual=r, act="e")
    if dtype == torch.float32:
        torch.testing.assert_close(y, y_p, rtol=0, atol=1e-5)
    else:  # one rounding of nearly the same fp32 value: within 1 bf16 ulp
        ulp = torch.finfo(torch.bfloat16).eps * y_p.float().abs().clamp_min(1e-30)
        assert bool(((y.float() - y_p.float()).abs() <= ulp).all())


# one shape per route of gn_moments_kernel: (shape, dtype, storage offset,
# groups, route of plan_moments)
_MOMENT_CASES = {
    "bulk-bf16": ((2, 64, 6, 10, 12), torch.bfloat16, 0, 8, "bulk"),
    "bulk-fp32-c12": ((2, 12, 5, 6, 7), torch.float32, 0, 4, "bulk"),
    "register-bf16-c12": ((2, 12, 5, 6, 7), torch.bfloat16, 0, 4, "register"),
    "register-unaligned": ((2, 32, 4, 5, 6), torch.bfloat16, 1, 8, "register"),
    "rows-below-one-block": ((3, 32, 1, 2, 3), torch.float32, 0, 8, "bulk"),
    "one-sample": ((1, 128, 12, 12, 12), torch.bfloat16, 0, 8, "bulk"),
    "many-blocks": ((2, 32, 40, 40, 40), torch.bfloat16, 0, 8, "bulk"),
    # the landmark model's deepest level (f_maps 64): 1024 channels, 128 a
    # group; fp32 rows of 4096 B fill all 256 consumers, 4 rows a stage
    "c1024-fp32": ((4, 1024, 6, 6, 6), torch.float32, 0, 8, "bulk"),
    "c1024-bf16": ((4, 1024, 6, 6, 6), torch.bfloat16, 0, 8, "bulk"),
    # UNet3D's input GroupNorm (order gcr): one channel in one group, read
    # as packed 16-byte vectors of 8 (bf16) or 4 (fp32) rows
    "c1-g1-bf16": ((2, 1, 12, 12, 12), torch.bfloat16, 0, 1, "packed"),
    "c1-g1-fp32": ((2, 1, 12, 12, 12), torch.float32, 0, 1, "packed"),
    "c1-g1-many-blocks": ((2, 1, 64, 64, 64), torch.bfloat16, 0, 1, "packed"),
    "c1-fp32-many-blocks": ((2, 1, 64, 64, 64), torch.float32, 0, 1, "packed"),
    # the packed route's other channel counts (lane k on channel k % C)
    "c2-packed-bf16": ((2, 2, 10, 12, 14), torch.bfloat16, 0, 1, "packed"),
    "c4-packed-bf16": ((2, 4, 10, 12, 14), torch.bfloat16, 0, 2, "packed"),
    "c2-packed-fp32": ((2, 2, 10, 12, 14), torch.float32, 0, 2, "packed"),
    # C < V where the packed route refuses: S * C not a multiple of V
    # (S = 105), an offset base
    "c2-odd-rows-register-bf16": ((2, 2, 3, 5, 7), torch.bfloat16, 0, 1, "register"),
    "c1-offset-register-bf16": ((2, 1, 12, 12, 12), torch.bfloat16, 1, 1, "register"),
    # configs/seg_tiny.yaml's 8 channels in 8 groups: one channel a group
    "c8-g8-bf16": ((2, 8, 10, 12, 14), torch.bfloat16, 0, 8, "bulk"),
    "c8-g8-fp32": ((2, 8, 10, 12, 14), torch.float32, 0, 8, "bulk"),
    # UNet3D's deepest concatenation: 768 bf16 channels, 1536-byte rows
    "c768-concat-bf16": ((2, 768, 6, 6, 6), torch.bfloat16, 0, 8, "bulk"),
}


def _moments_route(x):
    n, c = x.shape[:2]
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    return gn.plan_moments(n, x.numel() // (n * c), c, x.element_size(),
                           x.data_ptr() % 16 == 0, sms).route


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(_MOMENT_CASES))
def test_gn_moments_kernel_matches_plain_on_card(cuda_device, case):
    shape, dtype, offset, groups, route = _MOMENT_CASES[case]
    x = _activation(shape, dtype, cuda_device, 7, offset)
    c = shape[1]
    assert _moments_route(x) == route
    w = torch.rand(c, generator=torch.Generator().manual_seed(8)).to(cuda_device) + 0.5
    launched = gn.STATS_LAUNCHES
    stats = gn.group_norm_moments(x, groups, w, 1e-5)
    assert gn.STATS_LAUNCHES == launched + 1
    for got, ref in zip(stats, gn.group_norm_moments_plain(x, groups, w, 1e-5)):
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=0)


@pytest.mark.cuda
def test_gn_moments_kernel_is_deterministic(cuda_device):
    """Two calls are bitwise equal, with a call at another N between them,
    and every sample's ticket is back at 0 after each launch: on the bulk
    route, and on the packed route with the fold on and off."""
    a = _activation((4, 32, 24, 24, 24), torch.bfloat16, cuda_device, 9)
    b = _activation((2, 64, 8, 8, 8), torch.bfloat16, cuda_device, 10)
    w32, w64 = torch.ones(32, device=cuda_device), torch.ones(64, device=cuda_device)
    first = gn.group_norm_moments(a, 8, w32)
    gn.group_norm_moments(b, 8, w64)
    second = gn.group_norm_moments(a, 8, w32)
    torch.cuda.synchronize()
    for u, v in zip(first, second):
        assert torch.equal(u, v)
    assert int(gn._TICKETS[a.device].abs().sum()) == 0
    for dtype in (torch.bfloat16, torch.float32):
        p = _activation((4, 1, 48, 48, 48), dtype, cuda_device, 11)
        assert _moments_route(p) == "packed"
        w1 = torch.full((1,), 1.5, device=cuda_device)
        calls = []
        for _ in range(2):
            calls.append((*gn.group_norm_moments(p, 1, w1), gn.group_norm_sums(p)))
            gn.group_norm_moments(b, 8, w64)
            assert int(gn._TICKETS[p.device].abs().sum()) == 0
        for u, v in zip(*calls):
            assert torch.equal(u, v)


# (shape, dtype, groups, storage offset, route of plan_apply): the apply
# kernels' vector, packed and scalar routes at one channel a group, at
# UNet3D's concatenations, where S * C is not a multiple of V (S = 105)
# and at an offset base
_APPLY_CASES = {
    "c1-g1-bf16": ((2, 1, 12, 12, 12), torch.bfloat16, 1, 0, "packed"),
    "c1-g1-fp32": ((2, 1, 12, 12, 12), torch.float32, 1, 0, "packed"),
    "c8-g8-bf16": ((2, 8, 10, 12, 14), torch.bfloat16, 8, 0, "vector"),
    "c8-g8-fp32": ((2, 8, 10, 12, 14), torch.float32, 8, 0, "vector"),
    "c192-concat-bf16": ((2, 192, 8, 8, 8), torch.bfloat16, 8, 0, "vector"),
    "c768-concat-bf16": ((2, 768, 6, 6, 6), torch.bfloat16, 8, 0, "vector"),
    "c2-packed-bf16": ((2, 2, 10, 12, 14), torch.bfloat16, 1, 0, "packed"),
    "c4-packed-bf16": ((2, 4, 10, 12, 14), torch.bfloat16, 2, 0, "packed"),
    "c2-packed-fp32": ((2, 2, 10, 12, 14), torch.float32, 2, 0, "packed"),
    "c384-concat-bf16": ((2, 384, 6, 7, 8), torch.bfloat16, 8, 0, "vector"),
    "c4-odd-rows-bf16": ((2, 4, 3, 5, 7), torch.bfloat16, 4, 0, "scalar"),
    "c1-offset-bf16": ((2, 1, 12, 12, 12), torch.bfloat16, 1, 1, "scalar"),
    "c192-offset-bf16": ((2, 192, 4, 5, 6), torch.bfloat16, 8, 3, "scalar"),
}


def _apply_route(x, *others):
    n, c = x.shape[:2]
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, *others) if t is not None)
    return gn.plan_apply(n, x.numel() // (n * c), c, x.element_size(), aligned, sms).route


@pytest.mark.cuda
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("act", [None, "r"])
@pytest.mark.parametrize("case", list(_APPLY_CASES))
def test_gn_apply_kernel_matches_plain_on_card(cuda_device, case, act, residual):
    shape, dtype, groups, offset, route = _APPLY_CASES[case]
    x = _activation(shape, dtype, cuda_device, 21, offset)
    r = _activation(shape, dtype, cuda_device, 22, offset) if residual else None
    assert _apply_route(x, r) == route
    c = shape[1]
    g = torch.Generator().manual_seed(23)
    w = (torch.rand(c, generator=g) + 0.5).to(cuda_device)
    b = (torch.rand(c, generator=g) - 0.5).to(cuda_device)
    mean, mul, _ = gn.group_norm_moments_plain(x, groups, w, 1e-5)
    launched = gn.APPLY_LAUNCHES
    y = gn.group_norm_apply(x, mean, mul, b, residual=r, act=act)
    assert gn.APPLY_LAUNCHES == launched + 1
    y_p = gn.group_norm_apply_plain(x, mean, mul, b, residual=r, act=act)
    if dtype == torch.float32:
        torch.testing.assert_close(y, y_p, rtol=0, atol=1e-5)
    else:
        assert bool(((y.float() - y_p.float()).abs() <= _bf16_ulp(y_p.float())).all())


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["c1-g1-bf16", "c2-packed-fp32", "c4-odd-rows-bf16",
                                  "c192-offset-bf16", "c768-concat-bf16"])
def test_gn_apply_kernels_repeat_bitwise_one_launch_a_call(cuda_device, case):
    """Both apply kernels on each route: two calls bitwise equal, each call
    one launch of its kernel (and one of the backward's reduce)."""
    shape, dtype, groups, offset, _ = _APPLY_CASES[case]
    x = _activation(shape, dtype, cuda_device, 24, offset)
    r = _activation(shape, dtype, cuda_device, 25, offset) - 0.5
    dy = _activation(shape, dtype, cuda_device, 26, offset) - 0.5
    c = shape[1]
    w = torch.rand(c, generator=torch.Generator().manual_seed(27)).to(cuda_device) + 0.5
    b = torch.zeros(c, device=cuda_device)
    stats = gn.group_norm_moments_plain(x, groups, w, 1e-5)
    outs = []
    for _ in range(2):
        launched = (gn.APPLY_LAUNCHES, gn.BWD_REDUCE_LAUNCHES, gn.BWD_APPLY_LAUNCHES)
        y = gn.group_norm_apply(x, stats.mean, stats.mul, b, residual=r, act="e")
        assert gn.APPLY_LAUNCHES == launched[0] + 1
        grads = gn.group_norm_backward(x, dy, stats.mean, stats.rstd, w, b, groups, r, "e")
        assert (gn.BWD_REDUCE_LAUNCHES, gn.BWD_APPLY_LAUNCHES) == (launched[1] + 1,
                                                                   launched[2] + 1)
        outs.append((y, grads.dx, grads.dresidual))
    torch.cuda.synchronize()
    bits = lambda t: t.permute(0, 2, 3, 4, 1).flatten().view(torch.uint8)
    for u, v in zip(*outs):
        assert torch.equal(bits(u), bits(v))


# K2 cases: (volume shape, volume dtype, patch, corners) with corners
# misaligned by 1-7 elements and rows whose bytes are not a multiple of 16
_GATHER_CASES = {
    "f16-c1-odd-rows": ((40, 36, 44, 1), torch.float16, (16, 16, 13),
                        [[0, 0, z] for z in range(1, 8)] + [[8, 4, 12], [24, 20, 31]]),
    "fp32-c3": ((20, 18, 22, 3), torch.float32, (5, 4, 7),
                [[1, 2, 3], [0, 0, 1], [15, 14, 15], [7, 3, 5]]),
    "bf16-long-rows": ((6, 5, 30, 64), torch.bfloat16, (3, 2, 21),
                       [[0, 0, 1], [3, 3, 9], [2, 1, 5]]),
    # seg_brats_bf16's predict tiles: 4 f16 modalities cast to bf16, rows of
    # a 96-voxel tile's z extent (768 bytes) at misaligned corners
    "f16-c4": ((24, 20, 104, 4), torch.float16, (8, 6, 96),
               [[0, 0, z] for z in range(1, 8)] + [[16, 14, 8], [3, 5, 0]]),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(_GATHER_CASES))
def test_gather_kernel_byte_equal_at_misaligned_corners(cuda_device, case):
    shape, dtype, patch, corners = _GATHER_CASES[case]
    g = torch.Generator().manual_seed(11)
    vol = torch.randn(shape, generator=g).to(dtype).to(cuda_device)
    corners = np.asarray(corners, np.int32)
    for dt in (torch.float16, torch.bfloat16, torch.float32):
        got = P.extract_patches(vol, corners, patch, out_dtype=dt)
        ref = P.extract_patches_plain(vol, corners, patch, dt)
        assert torch.equal(got.view(-1).view(torch.uint8), ref.view(-1).view(torch.uint8))


@pytest.mark.cuda
def test_gather_kernel_matches_plain_on_card(cuda_device):
    g = torch.Generator().manual_seed(6)
    vol = torch.randn((40, 36, 44, 1), generator=g).half().to(cuda_device)
    corners = np.array([[0, 0, 0], [8, 4, 12], [8, 4, 12], [24, 20, 28]], np.int32)
    for dt in (torch.float16, torch.bfloat16, torch.float32):
        got = P.extract_patches(vol, corners, (16, 16, 16), out_dtype=dt)
        assert torch.equal(got, P.extract_patches_plain(vol, corners, (16, 16, 16), dt))


def _bf16_ulp(ref: torch.Tensor) -> torch.Tensor:
    _, exp = torch.frexp(ref.float())
    return torch.ldexp(torch.ones_like(ref, dtype=torch.float32), exp - 8)


def assert_grads_close(got, ref, dtype, held=()):
    """GroupNormGrads of the kernels against the plain closed form (but
    the outputs ``held`` to float64 instead)."""
    for name, g, r in zip(got._fields, got, ref):
        if r is None:
            assert g is None, name
            continue
        if name in held:
            continue
        g, r = g.float(), r.float()
        scale = float(r.abs().max())
        if name in ("dweight", "dbias"):
            tol = torch.full_like(r, 1e-4 * scale)
        elif dtype == torch.float32:
            tol = torch.full_like(r, 1e-5 * scale)
        else:
            tol = _bf16_ulp(r) + 1e-5 * scale
        assert bool(((g - r).abs() <= tol).all()), (name, float((g - r).abs().max()), scale)


# The cases whose dγ and dβ are held to float64 instead of to the plain
# path: at the fp32 C = 1 case over many blocks dγ is one sum over 8 x
# 32768 terms dz * xhat that cancel (with ELU and the residual to -1.227
# from a sum of magnitudes of 1.2e5), and two fp32 sums in different
# orders can each lie within 1e-4 x |dγ| of the exact sum yet differ from
# each other by more.  Every other output and case keeps
# assert_grads_close's bounds.
_FLOAT64_CASES = ("c1-packed-many-blocks-fp32",)


def hold_to_float64(got, ref, x, dy, stats, w, b, groups, r, act):
    """dγ and dβ of the kernel and of the plain path, each within 1e-4 x
    |float64 sum| of the float64 sum of its own fp32 terms (a line each
    printed: the float64 sum, the conditioning sum |terms| / |sum| and
    both paths' distances); the names held."""
    f64 = float64_sums(x, dy, stats, w, b, groups, r, act)
    for name, kernel64, plain64, mag in (
            ("dweight", f64["dgamma_kernel"], f64["dgamma_plain"], f64["dgamma_mag"]),
            ("dbias", f64["dbeta"], f64["dbeta"], f64["dbeta_mag"])):
        paths = [(path, value.double() - exact, exact)
                 for path, value, exact in (("kernel", getattr(got, name), kernel64),
                                            ("plain", getattr(ref, name), plain64))]
        print(f"{name} act={act} residual={r is not None}: float64 {plain64.tolist()}, "
              f"conditioning {(mag / plain64.abs()).tolist()}, " + ", ".join(
                  f"{path} off by {err.tolist()}" for path, err, _ in paths))
        for path, err, exact in paths:
            assert bool((err.abs() <= 1e-4 * exact.abs()).all()), (
                name, path, err.tolist(), exact.tolist())
    return ("dweight", "dbias")


def float64_sums(x, dy, stats, w, b, groups, r, act):
    """Per channel, in float64 from the fp32 terms each path forms: dγ as
    the plain path sums it (dz * xhat, xhat = (x - mean) * rstd rounded
    to fp32) and as the kernel does (rstd * sum dz * (x - mean) per
    sample), dβ = sum dz, and the sums of magnitudes of dγ's and dβ's
    terms."""
    xm, _, dz, _ = gn.backward_terms_plain(x, dy, stats.mean, stats.rstd, w, b, groups, r, act)
    n, c = stats.rstd.shape
    dz64 = dz.double()
    terms = dz64 * (xm * stats.rstd.view(n, c, 1, 1, 1)).double()
    dims = (0, 2, 3, 4)
    kernel = ((dz64 * xm.double()).sum(dim=(2, 3, 4)) * stats.rstd.double()).sum(0)
    return dict(dgamma_plain=terms.sum(dim=dims), dgamma_kernel=kernel,
                dbeta=dz64.sum(dim=dims), dgamma_mag=terms.abs().sum(dim=dims),
                dbeta_mag=dz64.abs().sum(dim=dims))


# (shape, dtype, storage offset, groups): the routes of both backward
# kernels (the apply's packed route at C < V, its scalar route where S * C
# is not a multiple of V or the base is offset), one block per sample and many
_BWD_CASES = {
    "bf16-vec": ((2, 64, 6, 10, 12), torch.bfloat16, 0, 8),
    "fp32-vec": ((2, 32, 5, 6, 7), torch.float32, 0, 8),
    "bf16-c12-scalar": ((2, 12, 5, 6, 7), torch.bfloat16, 0, 4),
    "bf16-unaligned": ((2, 32, 4, 5, 6), torch.bfloat16, 1, 8),
    "many-blocks": ((2, 32, 40, 40, 40), torch.bfloat16, 0, 8),
    "c1024-fp32": ((4, 1024, 6, 6, 6), torch.float32, 0, 8),
    "c1024-bf16": ((4, 1024, 6, 6, 6), torch.bfloat16, 0, 8),
    "c1-g1-bf16": ((2, 1, 12, 12, 12), torch.bfloat16, 0, 1),
    "c1-g1-fp32": ((2, 1, 12, 12, 12), torch.float32, 0, 1),
    "c1-g1-many-blocks": ((2, 1, 64, 64, 64), torch.bfloat16, 0, 1),
    "c8-g8-bf16": ((2, 8, 10, 12, 14), torch.bfloat16, 0, 8),
    "c8-g8-fp32": ((2, 8, 10, 12, 14), torch.float32, 0, 8),
    "c768-concat-bf16": ((2, 768, 6, 6, 6), torch.bfloat16, 0, 8),
    "c2-packed-bf16": ((2, 2, 10, 12, 14), torch.bfloat16, 0, 1),
    "c4-packed-bf16": ((2, 4, 10, 12, 14), torch.bfloat16, 0, 2),
    "c2-packed-fp32": ((2, 2, 10, 12, 14), torch.float32, 0, 2),
    "c384-concat-bf16": ((2, 384, 6, 7, 8), torch.bfloat16, 0, 8),
    "c4-odd-rows-bf16": ((2, 4, 3, 5, 7), torch.bfloat16, 0, 4),
    "c1-offset-bf16": ((2, 1, 12, 12, 12), torch.bfloat16, 1, 1),
    "c192-offset-bf16": ((2, 192, 4, 5, 6), torch.bfloat16, 3, 8),
    # the reduce's routes: C = 1 packed over many blocks (in fp32 dγ and dβ
    # held to float64: _FLOAT64_CASES), level 4 of the batch-32
    # step split across channel chunks, the ring over many blocks
    "c1-packed-many-blocks-bf16": ((8, 1, 32, 32, 32), torch.bfloat16, 0, 1),
    "c1-packed-many-blocks-fp32": ((8, 1, 32, 32, 32), torch.float32, 0, 1),
    "level4-chunks-bf16": ((32, 512, 6, 6, 6), torch.bfloat16, 0, 8),
    "level4-chunks-fp32": ((8, 512, 6, 6, 6), torch.float32, 0, 8),
    "ring-many-blocks-bf16": ((4, 32, 48, 48, 48), torch.bfloat16, 0, 8),
}
# what plan_bwd_reduce must pick at some of them
_REDUCE_EXPECT = {
    "c1-g1-bf16": dict(route="packed"), "c1-g1-fp32": dict(route="packed"),
    "c1-packed-many-blocks-bf16": dict(route="packed"),
    "c1-packed-many-blocks-fp32": dict(route="packed"),
    "level4-chunks-bf16": dict(route="vector", chunks=2),
    "level4-chunks-fp32": dict(route="vector", chunks=4),
    "c1-offset-bf16": dict(route="scalar"), "c4-odd-rows-bf16": dict(route="scalar"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("act", [None, "e", "r", "l"])
@pytest.mark.parametrize("case", list(_BWD_CASES))
def test_gn_backward_kernels_match_plain_on_card(cuda_device, case, act, residual):
    shape, dtype, offset, groups = _BWD_CASES[case]
    x = _activation(shape, dtype, cuda_device, 12, offset)
    dy = _activation(shape, dtype, cuda_device, 13, offset) - 0.5
    r = _activation(shape, dtype, cuda_device, 14, offset) - 0.5 if residual else None
    c = shape[1]
    g = torch.Generator().manual_seed(15)
    w = (torch.rand(c, generator=g) + 0.5).to(cuda_device)
    w[0] = 0.0  # the statistics' rstd carries the gradient where gamma is 0
    b = (torch.rand(c, generator=g) - 0.5).to(cuda_device)
    stats = gn.group_norm_moments_plain(x, groups, w, 1e-5)
    plan = gn.reduce_plan(x, dy, r, act)
    for field, want in _REDUCE_EXPECT.get(case, {}).items():
        assert getattr(plan, field) == want, (field, plan)
    launched = (gn.BWD_REDUCE_LAUNCHES, gn.BWD_APPLY_LAUNCHES)
    got = gn.group_norm_backward(x, dy, stats.mean, stats.rstd, w, b, groups, r, act)
    assert (gn.BWD_REDUCE_LAUNCHES, gn.BWD_APPLY_LAUNCHES) == (launched[0] + 1,
                                                               launched[1] + 1)
    assert int(gn._BWD_TICKETS[x.device].abs().sum()) == 0
    ref = gn.group_norm_backward_plain(x, dy, stats.mean, stats.rstd, w, b, groups, r, act)
    assert got.dx.is_contiguous(memory_format=CL3D)
    held = hold_to_float64(got, ref, x, dy, stats, w, b, groups, r, act) \
        if case in _FLOAT64_CASES else ()
    assert_grads_close(got, ref, dtype, held)
    again = gn.group_norm_backward(x, dy, stats.mean, stats.rstd, w, b, groups, r, act)
    for u, v in zip(got, again):
        assert u is None or torch.equal(u, v)
    assert int(gn._BWD_TICKETS[x.device].abs().sum()) == 0


# (shape, dtype, groups): shapes both reduce walks take (one chunk a row,
# 16-byte rows), several blocks a sample, with and without the residual
_RING_CASES = {
    "c32-bf16": ((4, 32, 40, 40, 40), torch.bfloat16, 8),
    "c64-fp32": ((2, 64, 24, 24, 24), torch.float32, 8),
    "c1-packed-bf16": ((8, 1, 48, 48, 48), torch.bfloat16, 1),
    "c1-packed-fp32": ((8, 1, 32, 32, 32), torch.float32, 1),
    "c256-level3-bf16": ((32, 256, 12, 12, 12), torch.bfloat16, 8),
}


@pytest.mark.cuda
@pytest.mark.parametrize("fold", [True, False])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("case", list(_RING_CASES))
def test_gn_bwd_reduce_walk_and_ring_match_plain_on_card(cuda_device, case, residual, fold):
    """The reduce on the walk and on the TMA ring (its planned stages, and
    stages of half as many rows) against ``backward_terms_plain`` (A, B
    and, folded, dx's coefficients) within 1e-4 x max |ref| per output;
    each bitwise equal from call to call, the tickets zero after each."""
    shape, dtype, groups = _RING_CASES[case]
    x = _activation(shape, dtype, cuda_device, 80)
    dy = _activation(shape, dtype, cuda_device, 81) - 0.5
    r = _activation(shape, dtype, cuda_device, 82) - 0.5 if residual else None
    c = shape[1]
    g = torch.Generator().manual_seed(83)
    w = (torch.rand(c, generator=g) + 0.5).to(cuda_device)
    b = (torch.rand(c, generator=g) - 0.5).to(cuda_device)
    stats = gn.group_norm_moments_plain(x, groups, w, 1e-5)
    coef = gn.backward_terms_plain(x, dy, stats.mean, stats.rstd, w, b, groups, r, "e")[3]
    ref = coef if fold else coef[:2]
    inputs = gn._backward_inputs(x, dy, stats.mean, stats.rstd, w, b, r)
    walk, ring = gn.reduce_plan(x, dy, r, ring=False), gn.reduce_plan(x, dy, r, ring=True)
    assert not walk.stage_rows and ring.stage_rows and walk.blocks > 1 and ring.blocks > 1
    for plan in (walk, ring, ring._replace(stage_rows=max(1, ring.stage_rows // 2))):
        calls = []
        for _ in range(2):
            calls.append(gn._bwd_reduce_cuda(x, dy, inputs, groups, r, "e", fold=fold,
                                             plan=plan))
            assert int(gn._BWD_TICKETS[x.device].abs().sum()) == 0
        assert torch.equal(calls[0], calls[1]), plan
        for q in range(len(ref)):
            err = float((calls[0][q] - ref[q]).abs().max())
            assert err <= 1e-4 * float(ref[q].abs().max()), (plan, q, err)


@pytest.mark.cuda
def test_group_norm_function_on_card_matches_plain_autograd(cuda_device):
    """The autograd Function on CUDA (forward and backward kernels) against
    torch autograd through the plain forward, fp32."""
    x = _activation((2, 32, 6, 6, 6), torch.float32, cuda_device, 16).requires_grad_()
    r = _activation((2, 32, 6, 6, 6), torch.float32, cuda_device, 17).requires_grad_()
    w = torch.rand(32, device=cuda_device).add_(0.5).requires_grad_()
    b = torch.rand(32, device=cuda_device).requires_grad_()
    dy = torch.randn_like(x)
    ins = (x, w, b, r)
    got = torch.autograd.grad(gn.group_norm(x, 8, w, b, residual=r, act="e"), ins, dy)
    ref = torch.autograd.grad(gn.group_norm_plain(x, 8, w, b, residual=r, act="e"), ins, dy)
    for u, v in zip(got, ref):
        assert float((u - v).abs().max()) <= 1e-4 * float(v.abs().max())


# indexed K2: stacked stores of bf16 images and uint8 labels, windows at
# corners misaligned by 1-7 elements and touching each store's last voxel;
# each store alone and both in one launch
def _fused(stores, corners, patch, subjects, out_dtypes=None):
    """Both stores in one call, held byte for byte to the plain version, one
    launch counted."""
    launched = P.LAUNCHES
    got = P.extract_patches_stores(stores, corners, patch, subjects, out_dtypes)
    assert P.LAUNCHES == launched + 1
    for out, store, dt in zip(got, stores, out_dtypes or [None] * len(stores)):
        ref = P.extract_patches_plain(store, corners, patch, dt, subjects=subjects)
        assert out.dtype == ref.dtype and out.shape == ref.shape
        assert torch.equal(out.view(-1).view(torch.uint8), ref.view(-1).view(torch.uint8))
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.uint8])
def test_indexed_gather_byte_equal_at_misaligned_corners(cuda_device, dtype):
    g = torch.Generator().manual_seed(18)
    store = (torch.rand((3, 30, 28, 40, 1), generator=g) * 255).to(dtype).to(cuda_device)
    corners = np.asarray([[0, 0, z] for z in range(1, 8)] + [[5, 7, 11], [14, 12, 24]],
                         np.int32)
    subjects = np.asarray([0, 1, 2, 2, 1, 0, 1, 2, 0], np.int32)
    launched = P.LAUNCHES
    got = P.extract_patches(store, corners, (16, 16, 16), subjects=subjects)
    assert P.LAUNCHES == launched + 1
    ref = P.extract_patches_plain(store, corners, (16, 16, 16), subjects=subjects)
    assert got.dtype == dtype
    assert torch.equal(got.view(-1).view(torch.uint8), ref.view(-1).view(torch.uint8))
    # the sampler's pair in one launch, the last window ending at the last voxel
    other = torch.bfloat16 if dtype == torch.uint8 else torch.uint8
    pair = (torch.rand((3, 30, 28, 40, 1), generator=g) * 255).to(other).to(cuda_device)
    corners[-1] = [14, 12, 24]
    _fused((store, pair), corners, (16, 16, 16), subjects)


@pytest.mark.cuda
def test_indexed_gather_of_four_channel_uint8_rows(cuda_device):
    """The landmark label store: 3 heatmaps + the class map per voxel, so a
    row of a 96-wide window is 384 B; z corners whose byte offset (4 z) is
    not a multiple of 16 put every row at another 16-byte phase; alone and
    fused with its bf16 image store."""
    g = torch.Generator().manual_seed(19)
    store = (torch.rand((3, 100, 98, 110, 4), generator=g) * 255).to(torch.uint8)
    store = store.to(cuda_device)
    corners = np.asarray([[0, 0, z] for z in range(1, 8)] + [[3, 1, 13], [4, 2, 14]],
                         np.int32)
    subjects = np.asarray([2, 0, 1, 2, 1, 0, 2, 1, 0], np.int32)
    launched = P.LAUNCHES
    got = P.extract_patches(store, corners, (96, 96, 96), subjects=subjects)
    assert P.LAUNCHES == launched + 1
    assert torch.equal(got, P.extract_patches_plain(store, corners, (96, 96, 96),
                                                    subjects=subjects))
    image = torch.randn((3, 100, 98, 110, 1), generator=g).to(torch.bfloat16).to(cuda_device)
    _fused((image, store), corners, (96, 96, 96), subjects)


# output rows of 1, 3, 17, 155 and 155 x 4 bytes (uint8) and 155 x 2 (bf16),
# rows longer than a piece (fp32 -> bf16 at 1500 channels), and casts in
# both stores of one launch
_FUSED_CASES = {
    "u8-row1": ((2, 9, 8, 7, 1), torch.uint8, None, (4, 5, 1)),
    "u8-row3": ((2, 9, 8, 7, 3), torch.uint8, None, (4, 5, 1)),
    "u8-row17": ((2, 9, 8, 23, 1), torch.uint8, None, (4, 5, 17)),
    "u8-row155": ((2, 9, 8, 163, 1), torch.uint8, None, (4, 5, 155)),
    "u8-row620": ((2, 9, 8, 163, 4), torch.uint8, None, (4, 5, 155)),
    "bf16-row310": ((2, 9, 8, 163, 1), torch.bfloat16, None, (4, 5, 155)),
    "f32-long-rows": ((2, 5, 4, 6, 1500), torch.float32, torch.bfloat16, (2, 3, 3)),
    "f16-cast": ((2, 9, 8, 23, 3), torch.float16, torch.float32, (4, 5, 17)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(_FUSED_CASES))
def test_fused_gather_of_odd_rows_byte_equal(cuda_device, case):
    """Each case's store fused with a bf16 -> f16 store of 2 channels: odd
    row lengths, windows at both ends of each axis, one launch."""
    shape, dtype, out_dtype, patch = _FUSED_CASES[case]
    g = torch.Generator().manual_seed(20)
    first = (torch.rand(shape, generator=g) * 255).to(dtype).to(cuda_device)
    second = torch.randn((*shape[:-1], 2), generator=g).to(torch.bfloat16).to(cuda_device)
    hi = [e - p for e, p in zip(shape[1:4], patch)]
    corners = np.asarray([[0, 0, 0], hi, [hi[0], 0, hi[2]], [0, hi[1], min(1, hi[2])],
                          [hi[0] // 2, hi[1] // 2, hi[2] // 2]], np.int32)
    subjects = np.asarray([1, 0, 1, 1, 0], np.int32)
    _fused((first, second), corners, patch, subjects, (out_dtype, torch.float16))
    _fused((first,), corners, patch, subjects, (out_dtype,))


# K1's fold-off route at seg_organ's level shapes at two space ranks: batch
# 4 of a 64 x 128 x 128 slab at level 0, (channels, slab extent) by level
_SLAB_LEVELS = [(32 * 2**i, (64 >> i, 128 >> i, 128 >> i)) for i in range(5)]
# and one channel in one group (the reduce's packed route)
_SLAB_CASES = _SLAB_LEVELS + [(1, (16, 32, 32))]


@pytest.mark.cuda
@pytest.mark.parametrize("level", range(len(_SLAB_CASES)))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gn_fold_off_route_matches_plain_on_card(cuda_device, dtype, level):
    """With the fold off, the moments kernel's per-(n, c) sums and the
    backward reduce's A and B against their plain versions within 1e-4 x
    max |ref| (per-(n, c) sums of another fp32 order); folded in torch
    (``fold_group_stats``, ``backward_coefficients``), equal to the
    fold-on route within rtol 1e-5 (another order of the group sum, and
    torch's rsqrt against the kernel's ``__frsqrt_rn``); one launch each,
    the reduce bitwise equal from call to call with its tickets zero."""
    c, ext = _SLAB_CASES[level]
    groups = min(8, c)
    shape = (4, c, *ext)
    x = _activation(shape, dtype, cuda_device, 30 + level)
    dy = _activation(shape, dtype, cuda_device, 50 + level) - 0.5
    r = _activation(shape, dtype, cuda_device, 70 + level) if level % 2 else None
    g = torch.Generator().manual_seed(level)
    w = (torch.rand(c, generator=g) + 0.5).to(cuda_device)
    b = (torch.rand(c, generator=g) - 0.5).to(cuda_device)
    spatial = x.numel() // (4 * c)

    assert _moments_route(x) == ("packed" if c == 1 else "bulk")
    launched = gn.STATS_LAUNCHES
    sums = gn.group_norm_sums(x)
    assert gn.STATS_LAUNCHES == launched + 1 and sums.shape == (2, 4, c)
    ref = torch.stack(gn.group_norm_stats_plain(x))
    assert float((sums - ref).abs().max()) <= 1e-4 * float(ref.abs().max())
    stats = gn.group_norm_moments(x, groups, w, 1e-5)
    for got, want in zip(gn.fold_group_stats(sums[0], sums[1], spatial, groups, w, 1e-5),
                         stats):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=0)

    launched = gn.BWD_REDUCE_LAUNCHES
    ab = gn.group_norm_backward_sums(x, dy, stats.mean, stats.rstd, w, b, groups, r, "e")
    assert gn.BWD_REDUCE_LAUNCHES == launched + 1 and ab.shape == (2, 4, c)
    assert int(gn._BWD_TICKETS[x.device].abs().sum()) == 0
    assert torch.equal(ab, gn.group_norm_backward_sums(x, dy, stats.mean, stats.rstd, w, b,
                                                       groups, r, "e"))
    assert int(gn._BWD_TICKETS[x.device].abs().sum()) == 0
    *_, a_p, b_p = gn.backward_sums_plain(x, dy, stats.mean, stats.rstd, w, b, r, "e")
    ab_ref = torch.stack((a_p, b_p))
    assert float((ab - ab_ref).abs().max()) <= 1e-4 * float(ab_ref.abs().max())
    coef = gn._bwd_reduce_cuda(x, dy, gn._backward_inputs(x, dy, stats.mean, stats.rstd, w, b,
                                                          r), groups, r, "e")
    for got, want in zip(gn.backward_coefficients(ab[0], ab[1], stats.rstd, w, groups,
                                                  spatial * (c // groups)), coef[2:]):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))


@pytest.mark.cuda
def test_slab_group_norm_function_of_one_slab_equals_group_norm_on_card(cuda_device):
    """``SlabGroupNormFunction`` with nothing to add (one slab) against
    ``GroupNormFunction``: the same four kernels, the fold moved to torch;
    y and the gradients within the fold's rtol 1e-5 carried through
    (1e-5 x max |ref|), dγ and dβ within 1e-4 x max |ref|."""
    shape = (2, 64, 12, 10, 8)
    x = _activation(shape, torch.float32, cuda_device, 90)
    r = _activation(shape, torch.float32, cuda_device, 91)
    dy = _activation(shape, torch.float32, cuda_device, 92)
    w = torch.rand(64, device=cuda_device) + 0.5
    b = torch.rand(64, device=cuda_device) - 0.5
    outs = []
    for slab in (False, True):
        xs, rs = x.clone().requires_grad_(True), r.clone().requires_grad_(True)
        ws, bs = w.clone().requires_grad_(True), b.clone().requires_grad_(True)
        if slab:
            y = gn.SlabGroupNormFunction.apply(xs, ws, bs, rs, 8, 1e-5, "e", lambda t: t,
                                               x[0, 0].numel())
        else:
            y = gn.GroupNormFunction.apply(xs, ws, bs, rs, 8, 1e-5, "e")
        y.backward(dy)
        outs.append((y.detach(), xs.grad, rs.grad, ws.grad, bs.grad))
    for i, (got, want) in enumerate(zip(*outs)):
        bound = (1e-4 if i >= 3 else 1e-5) * float(want.abs().max())
        assert float((got - want).abs().max()) <= bound, i


def _halo_rank(rank, port, out):
    """One of two gloo ranks on ``cuda:0``: a halo of 1 and (0, 1) around
    uneven CUDA slabs, with the gradient through it."""
    import torch.distributed as dist

    from tpu_mednet_torch.parallel import halo_exchange, make_mesh

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2,
                            rank=rank)
    dev = torch.device("cuda", 0)
    mesh = make_mesh(dev, devices=[dev, dev], n_space=2)
    g = torch.Generator().manual_seed(3)
    whole = torch.randn((2, 4, 16, 6, 5), generator=g).to(torch.bfloat16)
    grads = torch.randn((2, 4, 18, 6, 5), generator=g).to(torch.bfloat16)
    rows = slice(0, 10) if rank == 0 else slice(10, 16)
    x = whole[:, :, rows].to(dev).contiguous(memory_format=CL3D).requires_grad_(True)
    y = halo_exchange(x, 1, mesh, lengths=(10, 6))
    up = halo_exchange(x, (0, 1), mesh, lengths=(10, 6))
    gy = grads[:, :, rows.start:rows.stop + 2].to(dev)
    (y.float() * gy.float()).sum().backward()
    torch.save({"y": y.detach().cpu(), "up": up.detach().cpu(), "grad": x.grad.cpu(),
                "cuda": y.is_cuda and x.grad.is_cuda}, Path(out) / f"r{rank}.pt")
    dist.destroy_process_group()


@pytest.mark.cuda
def test_halo_exchange_of_cuda_slabs_through_gloo(cuda_device, tmp_path):
    """Two gloo ranks on one card exchange rows of CUDA slabs (staged
    through pinned host buffers): the padded slabs equal the zero-padded
    volume's rows exactly, and the gradient of each slab adds its halo
    rows' gradients sent back by the neighbour (within one bf16 rounding
    of the sum); the ranks are killed after 120 s."""
    import time

    import torch.multiprocessing as mp

    from tpu_mednet_torch.parallel.multihost import free_port

    ctx = mp.start_processes(_halo_rank, args=(free_port(), str(tmp_path)), nprocs=2,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + 120
    try:
        while not ctx.join(timeout=1):
            if time.monotonic() > deadline:
                pytest.fail("the halo ranks did not end within 120 s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    g = torch.Generator().manual_seed(3)
    whole = torch.randn((2, 4, 16, 6, 5), generator=g).to(torch.bfloat16)
    grads = torch.randn((2, 4, 18, 6, 5), generator=g).to(torch.bfloat16).float()
    padded = torch.nn.functional.pad(whole, (0, 0, 0, 0, 1, 1))
    grad = torch.zeros((2, 4, 18, 6, 5))
    outs = [torch.load(tmp_path / f"r{r}.pt") for r in range(2)]
    for r, (a, n) in enumerate(((0, 10), (10, 6))):
        assert outs[r]["cuda"]
        assert torch.equal(outs[r]["y"], padded[:, :, a:a + n + 2])
        assert torch.equal(outs[r]["up"], padded[:, :, a + 1:a + n + 2])
        grad[:, :, a:a + n + 2] += grads[:, :, a:a + n + 2]
    for r, (a, n) in enumerate(((0, 10), (10, 6))):
        want = grad[:, :, a + 1:a + n + 1]
        got = outs[r]["grad"].float()
        assert bool(((got - want).abs() <= bf16_ulp(want) + 1e-6).all()), r


def bf16_ulp(t: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at each value of ``t``."""
    _, exp = torch.frexp(t.float())
    return torch.ldexp(torch.ones_like(t, dtype=torch.float32), exp - 8)
