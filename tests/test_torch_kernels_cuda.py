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
# groups, bulk copies expected)
_MOMENT_CASES = {
    "bulk-bf16": ((2, 64, 6, 10, 12), torch.bfloat16, 0, 8, True),
    "bulk-fp32-c12": ((2, 12, 5, 6, 7), torch.float32, 0, 4, True),
    "register-bf16-c12": ((2, 12, 5, 6, 7), torch.bfloat16, 0, 4, False),
    "register-unaligned": ((2, 32, 4, 5, 6), torch.bfloat16, 1, 8, False),
    "rows-below-one-block": ((3, 32, 1, 2, 3), torch.float32, 0, 8, True),
    "one-sample": ((1, 128, 12, 12, 12), torch.bfloat16, 0, 8, True),
    "many-blocks": ((2, 32, 40, 40, 40), torch.bfloat16, 0, 8, True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(_MOMENT_CASES))
def test_gn_moments_kernel_matches_plain_on_card(cuda_device, case):
    shape, dtype, offset, groups, bulk = _MOMENT_CASES[case]
    x = _activation(shape, dtype, cuda_device, 7, offset)
    n, c = shape[:2]
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    plan = gn.plan_moments(n, x.numel() // (n * c), c, x.element_size(),
                           x.data_ptr() % 16 == 0, sms)
    assert plan.bulk == bulk
    w = torch.rand(c, generator=torch.Generator().manual_seed(8)).to(cuda_device) + 0.5
    launched = gn.STATS_LAUNCHES
    stats = gn.group_norm_moments(x, groups, w, 1e-5)
    assert gn.STATS_LAUNCHES == launched + 1
    for got, ref in zip(stats, gn.group_norm_moments_plain(x, groups, w, 1e-5)):
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=0)


@pytest.mark.cuda
def test_gn_moments_kernel_is_deterministic(cuda_device):
    """Two calls are bitwise equal, with a call at another N between them,
    and every sample's ticket is back at 0 after each launch."""
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


# K2 cases: (volume shape, volume dtype, patch, corners) with corners
# misaligned by 1-7 elements and rows whose bytes are not a multiple of 16
_GATHER_CASES = {
    "f16-c1-odd-rows": ((40, 36, 44, 1), torch.float16, (16, 16, 13),
                        [[0, 0, z] for z in range(1, 8)] + [[8, 4, 12], [24, 20, 31]]),
    "fp32-c3": ((20, 18, 22, 3), torch.float32, (5, 4, 7),
                [[1, 2, 3], [0, 0, 1], [15, 14, 15], [7, 3, 5]]),
    "bf16-long-rows": ((6, 5, 30, 64), torch.bfloat16, (3, 2, 21),
                       [[0, 0, 1], [3, 3, 9], [2, 1, 5]]),
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


def assert_grads_close(got, ref, dtype):
    """GroupNormGrads of the kernels against the plain closed form."""
    for name, g, r in zip(got._fields, got, ref):
        if r is None:
            assert g is None, name
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


# (shape, dtype, storage offset, groups): the vector and scalar routes of
# both backward kernels, one block per sample and many
_BWD_CASES = {
    "bf16-vec": ((2, 64, 6, 10, 12), torch.bfloat16, 0, 8),
    "fp32-vec": ((2, 32, 5, 6, 7), torch.float32, 0, 8),
    "bf16-c12-scalar": ((2, 12, 5, 6, 7), torch.bfloat16, 0, 4),
    "bf16-unaligned": ((2, 32, 4, 5, 6), torch.bfloat16, 1, 8),
    "many-blocks": ((2, 32, 40, 40, 40), torch.bfloat16, 0, 8),
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
    launched = (gn.BWD_REDUCE_LAUNCHES, gn.BWD_APPLY_LAUNCHES)
    got = gn.group_norm_backward(x, dy, stats.mean, stats.rstd, w, b, groups, r, act)
    assert (gn.BWD_REDUCE_LAUNCHES, gn.BWD_APPLY_LAUNCHES) == (launched[0] + 1,
                                                               launched[1] + 1)
    ref = gn.group_norm_backward_plain(x, dy, stats.mean, stats.rstd, w, b, groups, r, act)
    assert got.dx.is_contiguous(memory_format=CL3D)
    assert_grads_close(got, ref, dtype)
    again = gn.group_norm_backward(x, dy, stats.mean, stats.rstd, w, b, groups, r, act)
    for u, v in zip(got, again):
        assert u is None or torch.equal(u, v)
    assert int(gn._BWD_TICKETS[x.device].abs().sum()) == 0


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
# corners misaligned by 1-7 elements
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
