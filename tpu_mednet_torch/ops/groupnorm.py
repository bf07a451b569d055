"""GroupNorm forward: K1 statistics kernel + fused normalize/act kernel.

Counterpart of ``tpu_mednet/ops/pallas/groupnorm.py`` (``lane_moments``:
per-(batch, lane) fp32 sum and sum of squares in one streaming pass) and of
the group fold and normalize in ``tpu_mednet/ops/packed.py:142-190``.  On a
CUDA tensor the two hand-written kernels of ``csrc/groupnorm.cu`` run; on a
CPU tensor their plain PyTorch versions below run instead, and any other
device raises.

Activations are logical (N, C, D, H, W) stored ``channels_last_3d``, i.e.
physically (N, S, C) with S = D*H*W.  The (N, C) -> (N, G) fold, the clamp
``var = max(0, E[x^2] - mean^2)`` (flax's ``use_fast_variance`` path) and
``rsqrt(var + eps)`` act on (N, G) scalars in plain torch, as they stayed in
XLA in the JAX package.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from tpu_mednet_torch.ops import _build

# launch counters: +1 where the wrapper launches its kernel, nowhere else
STATS_LAUNCHES = 0
APPLY_LAUNCHES = 0

# order-string nonlinearity -> kernel act code (csrc/groupnorm.cu activate)
ACT_CODES = {None: 0, "r": 1, "l": 2, "e": 3}
LEAKY_SLOPE = 0.1
CL3D = torch.channels_last_3d

_STATS_ARGS = [
    ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
    ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
]
_APPLY_ARGS = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
    ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_float,
    ctypes.c_void_p,
]
# stats grid: enough (n, chunk) blocks to fill every SM several times over,
# but never a chunk shorter than this many rows
_BLOCKS_PER_SM = 8
_MIN_CHUNK_ROWS = 64


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


def _group_norm_stats_cuda(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    global STATS_LAUNCHES
    _build.require_cuda(x, "group_norm_stats")
    _check_activation(x, "group_norm_stats")
    n, c = x.shape[:2]
    s = x.numel() // (n * c)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    chunks = max(1, min(-(-_BLOCKS_PER_SM * sms // n), -(-s // _MIN_CHUNK_ROWS)))
    rows_per_chunk = -(-s // chunks)
    chunks = -(-s // rows_per_chunk)
    part = torch.empty((2, n, chunks, c), dtype=torch.float32, device=x.device)
    out = torch.empty((2, n, c), dtype=torch.float32, device=x.device)
    fn = _build.kernel("tmt_gn_stats", _STATS_ARGS)
    err = fn(x.data_ptr(), _build.DTYPE_CODES[x.dtype], n, s, c, chunks,
             rows_per_chunk, part[0].data_ptr(), part[1].data_ptr(),
             out[0].data_ptr(), out[1].data_ptr(), _build.stream_of(x))
    _build.check(err, "tmt_gn_stats")
    STATS_LAUNCHES += 1
    return out[0], out[1]


def group_norm_stats(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 statistics: (sum, sumsq), each (N, C) fp32."""
    if x.device.type == "cpu":
        return group_norm_stats_plain(x)
    return _group_norm_stats_cuda(x)


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
    activation: stats kernel, (N, G) fold, apply kernel."""
    n, c = x.shape[:2]
    if c % num_groups:
        raise ValueError(f"{c} channels not divisible into {num_groups} groups")
    s, q = group_norm_stats(x)
    mean_c, mul_c = fold_group_stats(s, q, x.numel() // (n * c), num_groups,
                                     weight, eps)
    return group_norm_apply(x, mean_c, mul_c, bias, residual, act)
