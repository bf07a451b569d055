"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda`` and skipped where ``torch.cuda.is_available()`` is false.
This file imports neither JAX nor tpu_mednet, so it also runs on a machine
without them, skipping the JAX test setup:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Tolerances: moments rtol 1e-5 (another fp32 summation order); the fused
apply atol 1e-5 in fp32 and within one bf16 ulp in bf16 (one rounding of
nearly the same fp32 value); gathers byte-equal.
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
    s, q = gn.group_norm_stats(x)
    s_p, q_p = gn.group_norm_stats_plain(x)
    torch.testing.assert_close(s, s_p, rtol=1e-5, atol=0)
    torch.testing.assert_close(q, q_p, rtol=1e-5, atol=0)
    mean_c, mul_c = gn.fold_group_stats(s_p, q_p, 720, 8, w, 1e-5)
    y = gn.group_norm_apply(x, mean_c, mul_c, b, residual=r, act="e")
    y_p = gn.group_norm_apply_plain(x, mean_c, mul_c, b, residual=r, act="e")
    if dtype == torch.float32:
        torch.testing.assert_close(y, y_p, rtol=0, atol=1e-5)
    else:  # one rounding of nearly the same fp32 value: within 1 bf16 ulp
        ulp = torch.finfo(torch.bfloat16).eps * y_p.float().abs().clamp_min(1e-30)
        assert bool(((y.float() - y_p.float()).abs() <= ulp).all())


@pytest.mark.cuda
def test_gather_kernel_matches_plain_on_card(cuda_device):
    g = torch.Generator().manual_seed(6)
    vol = torch.randn((40, 36, 44, 1), generator=g).half().to(cuda_device)
    corners = np.array([[0, 0, 0], [8, 4, 12], [8, 4, 12], [24, 20, 28]], np.int32)
    for dt in (torch.float16, torch.bfloat16, torch.float32):
        got = P.extract_patches(vol, corners, (16, 16, 16), out_dtype=dt)
        assert torch.equal(got, P.extract_patches_plain(vol, corners, (16, 16, 16), dt))
