"""GroupNorm: K1's moments and fused normalize/act kernels, and its backward.

Counterpart of ``tpu_mednet/ops/pallas/groupnorm.py`` (``lane_moments``:
per-(batch, lane) fp32 sum and sum of squares in one streaming pass, and
its custom VJP), of the group fold ``packed_group_norm_stats`` and of the
normalize in ``tpu_mednet/ops/packed.py:142-190`` / flax ``nn.GroupNorm``.
On a CUDA tensor the hand-written kernels of ``csrc/groupnorm.cu`` run:
forward, one launch from the activation to the per-(n, c) ``mean``,
``mul = rstd * gamma`` and ``rstd``, and one for the normalize; backward,
one reduce to per-(n, c) sums and dx's coefficients, and one elementwise
pass for dx (and the residual's gradient).  ``group_norm`` ties them into a
``torch.autograd.Function``.  On a CPU tensor their plain PyTorch versions
below run instead, and any other device raises.

Activations are logical (N, C, D, H, W) stored ``channels_last_3d``, i.e.
physically (N, S, C) with S = D*H*W.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from tpu_mednet_torch.ops import _build

# launch counters: +1 where the wrapper launches its kernel, nowhere else
STATS_LAUNCHES = 0
APPLY_LAUNCHES = 0
BWD_REDUCE_LAUNCHES = 0
BWD_APPLY_LAUNCHES = 0

# order-string nonlinearity -> kernel act code (csrc/groupnorm.cu activate)
ACT_CODES = {None: 0, "r": 1, "l": 2, "e": 3}
LEAKY_SLOPE = 0.1
CL3D = torch.channels_last_3d

_MOMENTS_ARGS = [
    ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_float, ctypes.c_int,
    ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p,
]
_APPLY_ARGS = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
    ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_float,
    ctypes.c_void_p,
]
_BWD_REDUCE_ARGS = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_longlong,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
]
_BWD_APPLY_ARGS = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
    ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
    ctypes.c_void_p,
]
# moments launch plan; _STAGE_BYTES and _CONSUMERS must match kMaxStageBytes
# and kConsumers in csrc/groupnorm.cu
_STAGE_BYTES = 16 * 1024   # one bulk copy into one stage of the ring
_CONSUMERS = 256           # threads that sum, one 16-byte vector each
_BLOCKS_PER_SM = 2         # grid of about one wave at the largest shapes
# the backward's reduce: several waves of blocks, so that a last partial
# wave stays short (its blocks hold fewer per SM than the moments kernel's)
_BWD_BLOCKS_PER_SM = 8
_MIN_BLOCK_BYTES = 64 * 1024
# per device: one int32 ticket per sample, zero between launches; the
# backward's reduce has its own
_TICKETS: Dict[torch.device, torch.Tensor] = {}
_BWD_TICKETS: Dict[torch.device, torch.Tensor] = {}


def activation_plain(x: torch.Tensor, act: Optional[str]) -> torch.Tensor:
    """The order-string nonlinearity (reference components.py:36-40)."""
    if act is None:
        return x
    if act == "r":
        return torch.relu(x)
    if act == "l":
        return torch.nn.functional.leaky_relu(x, LEAKY_SLOPE)
    if act == "e":
        return torch.nn.functional.elu(x)
    raise ValueError(f"unknown nonlinearity {act!r}")


def _check_activation(x: torch.Tensor, what: str) -> None:
    if x.dim() != 5:
        raise ValueError(f"{what}: expected (N, C, D, H, W), got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{what}: dtype {x.dtype} not supported (fp32, bf16)")
    if not x.is_contiguous(memory_format=CL3D):
        raise ValueError(f"{what}: tensor must be channels_last_3d contiguous")


# -- statistics ------------------------------------------------------------

class GroupNormStats(NamedTuple):
    """Per-(n, c) fp32 statistics of one GroupNorm, each (N, C)."""

    mean: torch.Tensor
    mul: torch.Tensor     # rstd * gamma
    rstd: torch.Tensor    # kept for the backward: mul / gamma fails at gamma = 0


def group_norm_stats_plain(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(n, c) fp32 (sum, sum of squares) over the spatial extent."""
    xf = x.float()
    return xf.sum(dim=(2, 3, 4)), xf.square().sum(dim=(2, 3, 4))


def fold_group_stats(s: torch.Tensor, q: torch.Tensor, spatial: int,
                     num_groups: int, weight: torch.Tensor, eps: float
                     ) -> GroupNormStats:
    """(N, C) moments -> per-(n, c) ``mean``, ``mul = rstd * gamma``, ``rstd``.

    The group fold of ``packed_group_norm_stats`` (ops/packed.py:142-171)
    with flax's clamp of the fast variance at 0.
    """
    n, c = s.shape
    cg = c // num_groups
    count = spatial * cg
    mean = s.view(n, num_groups, cg).sum(-1) / count
    var = (q.view(n, num_groups, cg).sum(-1) / count - mean.square()).clamp_min(0.0)
    rstd = torch.rsqrt(var + eps)
    mean_c = mean.repeat_interleave(cg, dim=1)
    rstd_c = rstd.repeat_interleave(cg, dim=1)
    return GroupNormStats(mean_c.contiguous(), (rstd_c * weight.float()).contiguous(),
                          rstd_c.contiguous())


def group_norm_moments_plain(x: torch.Tensor, num_groups: int,
                             weight: torch.Tensor, eps: float) -> GroupNormStats:
    """Per-(n, c) fp32 ``mean``, ``mul = rstd * gamma`` and ``rstd``."""
    n, c = x.shape[:2]
    return fold_group_stats(*group_norm_stats_plain(x), x.numel() // max(1, n * c),
                            num_groups, weight, eps)


class MomentsPlan(NamedTuple):
    """How ``gn_moments_kernel`` is launched for one activation shape."""

    bulk: bool            # rows streamed by bulk copies (else the register path)
    blocks: int           # blocks per sample
    rows_per_block: int
    stage_rows: int       # rows per bulk-copy stage (0 on the register path)


def plan_moments(n: int, s: int, c: int, esize: int, aligned: bool,
                 sms: int, blocks_per_sm: int = _BLOCKS_PER_SM) -> MomentsPlan:
    """Launch plan for N samples of S rows of C channels of ``esize`` bytes.

    Bulk copies need a 16-byte aligned base (``aligned``) and rows of a
    multiple of 16 bytes, and each consumer thread owns one 16-byte vector
    of a row.  The grid aims at ``blocks_per_sm`` blocks per SM over all
    samples, but never below ``_MIN_BLOCK_BYTES`` of input per block.
    """
    row_bytes = c * esize
    bulk = aligned and row_bytes % 16 == 0 and row_bytes // 16 <= _CONSUMERS
    per_sample = max(1, min(-(-blocks_per_sm * sms // n),
                            -(-s * row_bytes // _MIN_BLOCK_BYTES)))
    rows_per_block = max(1, -(-s // per_sample))
    blocks = max(1, -(-s // rows_per_block))
    return MomentsPlan(bulk, blocks, rows_per_block,
                       _STAGE_BYTES // row_bytes if bulk else 0)


def _tickets(device: torch.device, n: int, pool=_TICKETS) -> torch.Tensor:
    t = pool.get(device)
    if t is None or t.numel() < n:
        t = torch.zeros(max(n, 64), dtype=torch.int32, device=device)
        pool[device] = t
    return t


def _group_norm_moments_cuda(x, num_groups, weight, eps):
    global STATS_LAUNCHES
    _build.require_cuda(x, "group_norm_moments")
    _check_activation(x, "group_norm_moments")
    n, c = x.shape[:2]
    s = x.numel() // (n * c) if n * c else 0
    gamma = weight.float().contiguous()
    if gamma.shape != (c,) or gamma.device != x.device:
        raise ValueError("group_norm_moments: weight must be (C,) on x's device")
    out = torch.empty((3, n, c), dtype=torch.float32, device=x.device)
    if n == 0 or c == 0:
        return GroupNormStats(*out)
    plan = plan_moments(n, s, c, x.element_size(), x.data_ptr() % 16 == 0,
                        torch.cuda.get_device_properties(x.device).multi_processor_count)
    part = torch.empty((n, plan.blocks, 2, c), dtype=torch.float32, device=x.device)
    fn = _build.kernel("tmt_gn_moments", _MOMENTS_ARGS)
    err = fn(x.data_ptr(), _build.DTYPE_CODES[x.dtype], n, s, c, num_groups,
             gamma.data_ptr(), eps, plan.blocks, plan.rows_per_block, int(plan.bulk),
             plan.stage_rows, part.data_ptr(), _tickets(x.device, n).data_ptr(),
             out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
             _build.stream_of(x))
    _build.check(err, "tmt_gn_moments")
    STATS_LAUNCHES += 1
    return GroupNormStats(*out)


def group_norm_moments(x: torch.Tensor, num_groups: int, weight: torch.Tensor,
                       eps: float = 1e-5) -> GroupNormStats:
    """K1 moments: per-(n, c) fp32 ``mean``, ``mul = rstd * gamma``, ``rstd``.

    On CUDA one launch of ``gn_moments_kernel``.  Its per-sample tickets
    live in one buffer per device, so concurrent calls on two streams of
    one device are not supported.
    """
    if x.shape[1] % num_groups:
        raise ValueError(f"{x.shape[1]} channels not divisible into {num_groups} groups")
    if x.device.type == "cpu":
        return group_norm_moments_plain(x, num_groups, weight, eps)
    return _group_norm_moments_cuda(x, num_groups, weight, eps)


# -- normalize + affine (+ residual) (+ act) --------------------------------

def group_norm_apply_plain(x: torch.Tensor, mean_c: torch.Tensor,
                           mul_c: torch.Tensor, bias: torch.Tensor,
                           residual: Optional[torch.Tensor] = None,
                           act: Optional[str] = None) -> torch.Tensor:
    """fp32 ``act((x - mean) * mul + beta (+ residual))``, rounded once."""
    n, c = mean_c.shape
    y = (x.float() - mean_c.view(n, c, 1, 1, 1)) * mul_c.view(n, c, 1, 1, 1)
    y = y + bias.float().view(1, c, 1, 1, 1)
    if residual is not None:
        y = y + residual.float()
    y = activation_plain(y, act)
    return y.to(x.dtype).contiguous(memory_format=CL3D)


def _group_norm_apply_cuda(x, mean_c, mul_c, bias, residual=None, act=None):
    global APPLY_LAUNCHES
    _build.require_cuda(x, "group_norm_apply")
    _check_activation(x, "group_norm_apply")
    n, c = x.shape[:2]
    if residual is not None:
        if (residual.shape != x.shape or residual.dtype != x.dtype
                or residual.device != x.device
                or not residual.is_contiguous(memory_format=CL3D)):
            raise ValueError("group_norm_apply: residual must match x in shape, "
                             "dtype, device and channels_last_3d layout")
    mean_c = mean_c.float().contiguous()
    mul_c = mul_c.float().contiguous()
    beta = bias.float().contiguous()
    if mean_c.shape != (n, c) or mul_c.shape != (n, c) or beta.shape != (c,):
        raise ValueError("group_norm_apply: mean/mul must be (N, C), bias (C,)")
    for t in (mean_c, mul_c, beta):
        if t.device != x.device:
            raise ValueError("group_norm_apply: statistics on another device")
    y = torch.empty_like(x, memory_format=CL3D)
    fn = _build.kernel("tmt_gn_apply", _APPLY_ARGS)
    err = fn(x.data_ptr(), None if residual is None else residual.data_ptr(),
             y.data_ptr(), mean_c.data_ptr(), mul_c.data_ptr(), beta.data_ptr(),
             _build.DTYPE_CODES[x.dtype], n, x.numel() // (n * c), c,
             ACT_CODES[act], LEAKY_SLOPE, _build.stream_of(x))
    _build.check(err, "tmt_gn_apply")
    APPLY_LAUNCHES += 1
    return y


def group_norm_apply(x: torch.Tensor, mean_c: torch.Tensor, mul_c: torch.Tensor,
                     bias: torch.Tensor, residual: Optional[torch.Tensor] = None,
                     act: Optional[str] = None) -> torch.Tensor:
    """K1 apply: ``act((x - mean) * mul + beta (+ residual))`` in x's dtype."""
    if act not in ACT_CODES:
        raise ValueError(f"unknown nonlinearity {act!r}")
    if x.device.type == "cpu":
        return group_norm_apply_plain(x, mean_c, mul_c, bias, residual, act)
    return _group_norm_apply_cuda(x, mean_c, mul_c, bias, residual, act)


def group_norm_plain(x: torch.Tensor, num_groups: int, weight: torch.Tensor,
                     bias: torch.Tensor, eps: float = 1e-5,
                     residual: Optional[torch.Tensor] = None,
                     act: Optional[str] = None) -> torch.Tensor:
    """The plain forward on any device, differentiated by torch autograd:
    the reference the kernels and the closed-form backward are held to."""
    stats = group_norm_moments_plain(x, num_groups, weight, eps)
    return group_norm_apply_plain(x, stats.mean, stats.mul, bias, residual, act)


# -- backward -----------------------------------------------------------------

def activation_grad_plain(z: torch.Tensor, act: Optional[str]) -> torch.Tensor:
    """act'(z) in fp32, as torch's own backward of each nonlinearity takes it."""
    if act is None:
        return torch.ones_like(z)
    if act == "r":
        return (z > 0).to(z.dtype)
    if act == "l":
        return torch.where(z > 0, 1.0, LEAKY_SLOPE).to(z.dtype)
    if act == "e":
        return torch.where(z > 0, torch.ones_like(z), torch.exp(z))
    raise ValueError(f"unknown nonlinearity {act!r}")


class GroupNormGrads(NamedTuple):
    dx: torch.Tensor
    dweight: torch.Tensor
    dbias: torch.Tensor
    dresidual: Optional[torch.Tensor]


def group_norm_backward_plain(x: torch.Tensor, dy: torch.Tensor, mean_c: torch.Tensor,
                              rstd_c: torch.Tensor, weight: torch.Tensor,
                              bias: torch.Tensor, num_groups: int,
                              residual: Optional[torch.Tensor] = None,
                              act: Optional[str] = None) -> GroupNormGrads:
    """The closed-form backward of ``group_norm`` in fp32 torch ops.

    With z the forward's pre-activation, dz = dy * act'(z) and
    xhat = (x - mean) * rstd, per (n, c): A = sum dz, B = sum dz * xhat;
    dbias = sum_n A, dweight = sum_n B, dresidual = dz and
    dx = mul * dz + coeff_b * (x - mean) + coeff_c with, per group,
    coeff_b = -rstd^2 * sum(gamma B) / M, coeff_c = -rstd * sum(gamma A) / M
    (M = elements per group).  The kernels compute the same, in this order,
    except that the reduce sums B as rstd * sum dz * (x - mean).
    """
    n, c = mean_c.shape
    view = (n, c, 1, 1, 1)
    # the forward's z, each operation rounded as in the forward
    xm = x.float() - mean_c.view(view)
    mul = rstd_c * weight.float()
    z = xm * mul.view(view) + bias.float().view(1, c, 1, 1, 1)
    if residual is not None:
        z = z + residual.float()
    dz = dy.float() * activation_grad_plain(z, act)
    del z
    a = dz.sum(dim=(2, 3, 4))
    b = (dz * (xm * rstd_c.view(view))).sum(dim=(2, 3, 4))
    cg = c // num_groups
    count = (x.numel() // max(1, n * c)) * cg
    gw = weight.float()
    sa = (gw * a).view(n, num_groups, cg).sum(-1).repeat_interleave(cg, dim=1)
    sb = (gw * b).view(n, num_groups, cg).sum(-1).repeat_interleave(cg, dim=1)
    coeff_b = -(rstd_c * rstd_c * sb / count)
    coeff_c = -(rstd_c * sa / count)
    dx = mul.view(view) * dz + coeff_b.view(view) * xm + coeff_c.view(view)
    dr = None if residual is None else dz.to(x.dtype).contiguous(memory_format=CL3D)
    return GroupNormGrads(dx.to(x.dtype).contiguous(memory_format=CL3D),
                          b.sum(0).to(weight.dtype), a.sum(0).to(bias.dtype), dr)


def _group_norm_backward_cuda(x, dy, mean_c, rstd_c, weight, bias, num_groups,
                              residual=None, act=None):
    global BWD_REDUCE_LAUNCHES, BWD_APPLY_LAUNCHES
    _build.require_cuda(x, "group_norm_backward")
    _check_activation(x, "group_norm_backward")
    for t, what in ((dy, "dy"), (residual, "residual")):
        if t is not None and (t.shape != x.shape or t.dtype != x.dtype
                              or t.device != x.device
                              or not t.is_contiguous(memory_format=CL3D)):
            raise ValueError(f"group_norm_backward: {what} must match x in shape, "
                             "dtype, device and channels_last_3d layout")
    n, c = x.shape[:2]
    s = x.numel() // (n * c)
    small = [t.float().contiguous() for t in (mean_c, rstd_c, weight, bias)]
    if any(t.device != x.device for t in small) or small[0].shape != (n, c) \
            or small[1].shape != (n, c) or small[2].shape != (c,) or small[3].shape != (c,):
        raise ValueError("group_norm_backward: mean/rstd must be (N, C) and "
                         "weight/bias (C,) on x's device")
    mean_c, rstd_c, gamma, beta = small
    plan = plan_moments(n, s, c, x.element_size(), False,
                        torch.cuda.get_device_properties(x.device).multi_processor_count,
                        _BWD_BLOCKS_PER_SM)
    part = torch.empty((n, plan.blocks, 2, c), dtype=torch.float32, device=x.device)
    coef = torch.empty((4, n, c), dtype=torch.float32, device=x.device)
    res_ptr = None if residual is None else residual.data_ptr()
    stream = _build.stream_of(x)
    fn = _build.kernel("tmt_gn_bwd_reduce", _BWD_REDUCE_ARGS)
    err = fn(x.data_ptr(), dy.data_ptr(), res_ptr, _build.DTYPE_CODES[x.dtype], n, s, c,
             num_groups, mean_c.data_ptr(), rstd_c.data_ptr(), gamma.data_ptr(),
             beta.data_ptr(), ACT_CODES[act], LEAKY_SLOPE, plan.blocks,
             plan.rows_per_block, part.data_ptr(),
             _tickets(x.device, n, _BWD_TICKETS).data_ptr(), coef.data_ptr(), stream)
    _build.check(err, "tmt_gn_bwd_reduce")
    BWD_REDUCE_LAUNCHES += 1
    dx = torch.empty_like(x, memory_format=CL3D)
    dr = None if residual is None else torch.empty_like(x, memory_format=CL3D)
    fn = _build.kernel("tmt_gn_bwd_apply", _BWD_APPLY_ARGS)
    err = fn(x.data_ptr(), dy.data_ptr(), res_ptr, dx.data_ptr(),
             None if dr is None else dr.data_ptr(), _build.DTYPE_CODES[x.dtype], n, s, c,
             mean_c.data_ptr(), rstd_c.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
             coef.data_ptr(), ACT_CODES[act], LEAKY_SLOPE, stream)
    _build.check(err, "tmt_gn_bwd_apply")
    BWD_APPLY_LAUNCHES += 1
    return GroupNormGrads(dx, coef[1].sum(0).to(weight.dtype),
                          coef[0].sum(0).to(bias.dtype), dr)


def group_norm_backward(x: torch.Tensor, dy: torch.Tensor, mean_c: torch.Tensor,
                        rstd_c: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                        num_groups: int, residual: Optional[torch.Tensor] = None,
                        act: Optional[str] = None) -> GroupNormGrads:
    """K1 backward: (dx, dweight, dbias, dresidual) of ``group_norm``.

    On CUDA one launch of ``gn_bwd_reduce_kernel`` and one of
    ``gn_bwd_apply_kernel``.  The reduce's tickets live in one buffer per
    device, so concurrent calls on two streams of one device are not
    supported.
    """
    if act not in ACT_CODES:
        raise ValueError(f"unknown nonlinearity {act!r}")
    if x.device.type == "cpu":
        return group_norm_backward_plain(x, dy, mean_c, rstd_c, weight, bias,
                                         num_groups, residual, act)
    return _group_norm_backward_cuda(x, dy, mean_c, rstd_c, weight, bias,
                                     num_groups, residual, act)


class GroupNormFunction(torch.autograd.Function):
    """``group_norm`` under autograd: K1's forward kernels, and K1's
    backward kernels for the gradient.  Saves x, the residual and the
    per-(n, c) mean and rstd; z is recomputed in the backward."""

    @staticmethod
    def forward(ctx, x, weight, bias, residual, num_groups, eps, act):
        stats = group_norm_moments(x, num_groups, weight, eps)
        y = group_norm_apply(x, stats.mean, stats.mul, bias, residual, act)
        ctx.save_for_backward(x, weight, bias, residual, stats.mean, stats.rstd)
        ctx.num_groups, ctx.act = num_groups, act
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, bias, residual, mean_c, rstd_c = ctx.saved_tensors
        dy = dy.contiguous(memory_format=CL3D)
        g = group_norm_backward(x, dy, mean_c, rstd_c, weight, bias, ctx.num_groups,
                                residual, ctx.act)
        return g.dx, g.dweight, g.dbias, g.dresidual, None, None, None


def group_norm(x: torch.Tensor, num_groups: int, weight: torch.Tensor,
               bias: torch.Tensor, eps: float = 1e-5,
               residual: Optional[torch.Tensor] = None,
               act: Optional[str] = None) -> torch.Tensor:
    """GroupNorm (+ residual add) (+ nonlinearity) of a channels_last_3d
    activation, differentiable: the moments kernel, then the apply kernel;
    the backward kernels under autograd."""
    return GroupNormFunction.apply(x, weight, bias, residual, num_groups, eps, act)
