"""GroupNorm forward: K1 moments kernel + fused normalize/act kernel.

Counterpart of ``tpu_mednet/ops/pallas/groupnorm.py`` (``lane_moments``:
per-(batch, lane) fp32 sum and sum of squares in one streaming pass), of
the group fold ``packed_group_norm_stats`` and of the normalize in
``tpu_mednet/ops/packed.py:142-190``.  On a CUDA tensor the two
hand-written kernels of ``csrc/groupnorm.cu`` run: one launch from the
activation to the per-(n, c) ``mean`` and ``mul = rstd * gamma``, one for
the normalize.  On a CPU tensor their plain PyTorch versions below run
instead, and any other device raises.

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

# order-string nonlinearity -> kernel act code (csrc/groupnorm.cu activate)
ACT_CODES = {None: 0, "r": 1, "l": 2, "e": 3}
LEAKY_SLOPE = 0.1
CL3D = torch.channels_last_3d

_MOMENTS_ARGS = [
    ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_float, ctypes.c_int,
    ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
]
_APPLY_ARGS = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
    ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_float,
    ctypes.c_void_p,
]
# moments launch plan; _STAGE_BYTES and _CONSUMERS must match kMaxStageBytes
# and kConsumers in csrc/groupnorm.cu
_STAGE_BYTES = 16 * 1024   # one bulk copy into one stage of the ring
_CONSUMERS = 256           # threads that sum, one 16-byte vector each
_BLOCKS_PER_SM = 2         # grid of about one wave at the largest shapes
_MIN_BLOCK_BYTES = 64 * 1024
# per device: one int32 ticket per sample, zero between launches
_TICKETS: Dict[torch.device, torch.Tensor] = {}


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

def group_norm_stats_plain(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(n, c) fp32 (sum, sum of squares) over the spatial extent."""
    xf = x.float()
    return xf.sum(dim=(2, 3, 4)), xf.square().sum(dim=(2, 3, 4))


def fold_group_stats(s: torch.Tensor, q: torch.Tensor, spatial: int,
                     num_groups: int, weight: torch.Tensor, eps: float
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, C) moments -> per-(n, c) ``mean`` and ``mul = rstd * gamma``.

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
    mul_c = rstd.repeat_interleave(cg, dim=1) * weight.float()
    return mean_c.contiguous(), mul_c.contiguous()


def group_norm_moments_plain(x: torch.Tensor, num_groups: int,
                             weight: torch.Tensor, eps: float
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(n, c) fp32 ``mean`` and ``mul = rstd * gamma``, each (N, C)."""
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
                 sms: int) -> MomentsPlan:
    """Launch plan for N samples of S rows of C channels of ``esize`` bytes.

    Bulk copies need a 16-byte aligned base (``aligned``) and rows of a
    multiple of 16 bytes, and each consumer thread owns one 16-byte vector
    of a row.  The grid aims at ``_BLOCKS_PER_SM`` blocks per SM over all
    samples, but never below ``_MIN_BLOCK_BYTES`` of input per block.
    """
    row_bytes = c * esize
    bulk = aligned and row_bytes % 16 == 0 and row_bytes // 16 <= _CONSUMERS
    per_sample = max(1, min(-(-_BLOCKS_PER_SM * sms // n),
                            -(-s * row_bytes // _MIN_BLOCK_BYTES)))
    rows_per_block = max(1, -(-s // per_sample))
    blocks = max(1, -(-s // rows_per_block))
    return MomentsPlan(bulk, blocks, rows_per_block,
                       _STAGE_BYTES // row_bytes if bulk else 0)


def _tickets(device: torch.device, n: int) -> torch.Tensor:
    t = _TICKETS.get(device)
    if t is None or t.numel() < n:
        t = torch.zeros(max(n, 64), dtype=torch.int32, device=device)
        _TICKETS[device] = t
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
    out = torch.empty((2, n, c), dtype=torch.float32, device=x.device)
    if n == 0 or c == 0:
        return out[0], out[1]
    plan = plan_moments(n, s, c, x.element_size(), x.data_ptr() % 16 == 0,
                        torch.cuda.get_device_properties(x.device).multi_processor_count)
    part = torch.empty((n, plan.blocks, 2, c), dtype=torch.float32, device=x.device)
    fn = _build.kernel("tmt_gn_moments", _MOMENTS_ARGS)
    err = fn(x.data_ptr(), _build.DTYPE_CODES[x.dtype], n, s, c, num_groups,
             gamma.data_ptr(), eps, plan.blocks, plan.rows_per_block, int(plan.bulk),
             plan.stage_rows, part.data_ptr(), _tickets(x.device, n).data_ptr(),
             out[0].data_ptr(), out[1].data_ptr(), _build.stream_of(x))
    _build.check(err, "tmt_gn_moments")
    STATS_LAUNCHES += 1
    return out[0], out[1]


def group_norm_moments(x: torch.Tensor, num_groups: int, weight: torch.Tensor,
                       eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 moments: per-(n, c) fp32 ``mean`` and ``mul = rstd * gamma``.

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


def group_norm(x: torch.Tensor, num_groups: int, weight: torch.Tensor,
               bias: torch.Tensor, eps: float = 1e-5,
               residual: Optional[torch.Tensor] = None,
               act: Optional[str] = None) -> torch.Tensor:
    """GroupNorm (+ residual add) (+ nonlinearity) of a channels_last_3d
    activation: the moments kernel, then the apply kernel."""
    mean_c, mul_c = group_norm_moments(x, num_groups, weight, eps)
    return group_norm_apply(x, mean_c, mul_c, bias, residual, act)
