"""K1 as Swin UNETR's InstanceNorm on the card: one channel a group,
affine-free, LeakyReLU at 0.01, at the BTCV cell's largest shape.

Marked ``cuda`` and skipped where ``torch.cuda.is_available()`` is false.
This file imports neither JAX nor tpu_mednet, so it runs on a machine
without them:

    python -m pytest --noconftest -m cuda tests/test_torch_swin_unetr_cuda.py

The reference is the same function in float64 (statistics, normalisation,
residual add, LeakyReLU, and its autograd gradient) on the card.
Tolerances: y and dx within one bf16 ulp of the float64 value (the kernels
round an fp32 value once) plus 1e-4 x max |ref| (the fp32 sums over the
884,736 voxels of a channel, in another order than float64's).  The
gradients leave out the voxels whose pre-activation z lies within 1e-5 of
0, where fp32's z (error about 1e-6) may take the other sign than
float64's and so the other slope (at most 1e-4 of the voxels).
"""

import pytest
import torch

from tpu_mednet_torch.ops import groupnorm as gn

CL3D = torch.channels_last_3d
SHAPE = (2, 48, 96, 96, 96)
SLOPE = 0.01


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _bf16(seed: int, device, shift: float = 0.0) -> torch.Tensor:
    g = torch.Generator(device=device).manual_seed(seed)
    n, c, *sp = SHAPE
    x = torch.randn((n, *sp, c), generator=g, device=device) + shift
    return x.to(torch.bfloat16).permute(0, 4, 1, 2, 3)


def _instance_norm64(x, residual, act=True):
    mean = x.mean(dim=(2, 3, 4), keepdim=True)
    var = (x - mean).square().mean(dim=(2, 3, 4), keepdim=True)
    z = (x - mean) * torch.rsqrt(var + 1e-5)
    if residual is not None:
        z = z + residual
    return torch.nn.functional.leaky_relu(z, SLOPE) if act else z


def _close(got: torch.Tensor, ref: torch.Tensor, keep=None) -> None:
    ref = ref.to(torch.float64)
    err = (got.to(torch.float64) - ref).abs()
    bound = ref.abs() * 2.0 ** -8 + 1e-4 * ref.abs().max()
    ok = err <= bound
    if keep is not None:
        ok = ok | ~keep
    assert bool(ok.all()), (float((err - bound)[~ok].max()), int((~ok).sum()))


@pytest.mark.cuda
@pytest.mark.parametrize("residual", [False, True], ids=["norm1", "norm2-residual"])
def test_k1_instance_norm_leaky_on_card(cuda_device, residual):
    x = _bf16(1, cuda_device, shift=0.5).requires_grad_()
    r = _bf16(2, cuda_device).requires_grad_() if residual else None
    assert x.is_contiguous(memory_format=CL3D)
    ones = torch.ones(SHAPE[1], device=cuda_device)
    zeros = torch.zeros(SHAPE[1], device=cuda_device)
    y = gn.group_norm(x, SHAPE[1], ones, zeros, residual=r, act="l", slope=SLOPE)
    dy = _bf16(3, cuda_device)
    y.backward(dy)

    x64 = x.detach().double().requires_grad_()
    r64 = None if r is None else r.detach().double().requires_grad_()
    z64 = _instance_norm64(x64, r64, act=False)
    keep = z64.detach().abs() > 1e-5
    assert int((~keep).sum()) <= 1e-4 * keep.numel()
    y64 = torch.nn.functional.leaky_relu(z64, SLOPE)
    y64.backward(dy.double())
    _close(y, y64)
    _close(x.grad, x64.grad, keep)
    if residual:
        _close(r.grad, r64.grad, keep)
    # the slope reaches the kernels: 0.1 (the default) gives another result
    y_default = gn.group_norm(x.detach(), SHAPE[1], ones, zeros, residual=None if r is None
                              else r.detach(), act="l")
    assert not torch.equal(y_default, y.detach())
