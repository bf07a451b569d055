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

For a volume split along X over ranks (``parallel/halo.py``), both reduces
also stop at the per-(n, c) sums (``group_norm_sums``,
``group_norm_backward_sums``: the kernels with their fold off), which
``SlabGroupNormFunction`` adds over the slab's ranks and folds from the
global count before the applies, as the TPU kernel's per-lane sums are
all-reduced under the JAX package's ``space`` axis.

The forward pair is registered as two ``torch.library`` custom ops,
``tpu_mednet_torch::gn_moments`` and ``tpu_mednet_torch::gn_apply``
(each calls its wrapper below: the kernel on CUDA, the plain version on
the CPU; a fake implementation with the real one's shapes, dtypes and
strides), so ``torch.export`` can trace a model through K1 and an
exported artifact calls the kernels by name (``inference/serving.py``);
importing this module registers them.  ``group_norm`` goes through the
ops where nothing needs a gradient (serving, export); under autograd
``GroupNormFunction`` calls the wrappers without the dispatcher.

Activations are logical (N, C, D, H, W) stored ``channels_last_3d``, i.e.
physically (N, S, C) with S = D*H*W.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch import Tensor

from tpu_mednet_torch.ops import _build

# launch counters: +1 where the wrapper launches its kernel, nowhere else
STATS_LAUNCHES = 0
APPLY_LAUNCHES = 0
BWD_REDUCE_LAUNCHES = 0
BWD_APPLY_LAUNCHES = 0

# order-string nonlinearity -> kernel act code (csrc/groupnorm.cu activate)
ACT_CODES = {None: 0, "r": 1, "l": 2, "e": 3}
# LeakyReLU's negative slope where a call gives none (the order-string
# DSL's ``l``); every entry takes its own (InstanceNorm blocks: 0.01)
LEAKY_SLOPE = 0.1
CL3D = torch.channels_last_3d

_MOMENTS_ARGS = [
    ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_float, ctypes.c_int,
    ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_void_p,
]
# the apply plan's fields (route, blocks, rows per block, threads, chunk)
_PLAN_ARGS = [ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
_APPLY_ARGS = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
    ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_float,
    *_PLAN_ARGS, ctypes.c_void_p,
]
# the reduce plan's fields: the apply plan's, then rows a ring stage
_REDUCE_PLAN_ARGS = [*_PLAN_ARGS, ctypes.c_int]
_BWD_REDUCE_ARGS = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_float, *_REDUCE_PLAN_ARGS,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
]
_REDUCE_INFO_ARGS = [
    ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, *_REDUCE_PLAN_ARGS, ctypes.c_void_p,
]
_BWD_APPLY_ARGS = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
    ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
    *_PLAN_ARGS, ctypes.c_void_p,
]
# moments launch plan; _STAGE_BYTES and _CONSUMERS must match kMaxStageBytes
# and kConsumers in csrc/groupnorm.cu
_STAGE_BYTES = 16 * 1024   # one bulk copy into one stage of the ring
_CONSUMERS = 256           # threads that sum, one 16-byte vector each
_BLOCKS_PER_SM = 2         # grid of about one wave at the largest shapes
_MIN_BLOCK_BYTES = 64 * 1024
# the backward's reduce; _REDUCE_THREADS, _REDUCE_ROWS, _RING_STAGES and the
# blocks an SM holds must match kReduceMaxThreads, kReduceRows, kStages,
# kWalkBlocksPerSm and kRingBlocksPerSm in csrc/groupnorm.cu
_REDUCE_THREADS = 256       # consumer threads a block, at most
_REDUCE_ROWS = 4            # rows a thread loads before it uses the first (walk)
_REDUCE_CHUNK = 32          # vectors of a row a block takes at most (grid z beyond)
_WALK_BLOCKS_PER_SM = 2     # the launch bounds' promise: the grid is one wave
_RING_BLOCKS_PER_SM = 3
_RING_STAGES = 4
_RING_BYTES = 64 * 1024     # the ring of a block: stages of every operand
# stages a block streams at least where the planner takes the ring: with
# ELU (an exp an element) the walk's two blocks an SM cannot hide the
# arithmetic and the ring's three win from a few dozen stages; otherwise
# the walk keeps up until blocks are long (chip_bwd_reduce.py)
_RING_MIN_STAGES = 32
_RING_MIN_STAGES_CHEAP_ACT = 256
# apply launch plan; _APPLY_MAX_THREADS must match kApplyMaxThreads and
# _APPLY_ROWS kApplyRows in csrc/groupnorm.cu
_APPLY_THREADS = 256       # threads a block aims at
_APPLY_MAX_THREADS = 512   # the kernels' launch bound
_APPLY_ROWS = 4            # rows a thread loads before it uses the first
_APPLY_BLOCKS_PER_SM = 32  # grid of many short blocks: the last wave stays short
_APPLY_MAX_ROWS = 32       # rows a thread takes at most, in steps of _APPLY_ROWS
APPLY_ROUTES = ("vector", "packed", "scalar")   # csrc/groupnorm.cu ApplyRoute
MOMENTS_ROUTES = ("bulk", "packed", "register")  # csrc/groupnorm.cu MomentsRoute
# per device: one int32 ticket per sample, zero between launches; the
# backward's reduce has its own
_TICKETS: Dict[torch.device, torch.Tensor] = {}
_BWD_TICKETS: Dict[torch.device, torch.Tensor] = {}


def activation_plain(x: torch.Tensor, act: Optional[str],
                     slope: float = LEAKY_SLOPE) -> torch.Tensor:
    """The order-string nonlinearity (reference components.py:36-40);
    ``slope`` is LeakyReLU's negative slope."""
    if act is None:
        return x
    if act == "r":
        return torch.relu(x)
    if act == "l":
        return torch.nn.functional.leaky_relu(x, slope)
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

    route: str            # "bulk", "packed" or "register" (MOMENTS_ROUTES)
    blocks: int           # blocks per sample
    rows_per_block: int   # rows of the walk: spatial rows, or 16-byte vectors (packed)
    stage_rows: int       # rows per bulk-copy stage (0 on the register path)


def plan_moments(n: int, s: int, c: int, esize: int, aligned: bool,
                 sms: int) -> MomentsPlan:
    """Launch plan for N samples of S rows of C channels of ``esize`` bytes.

    Bulk copies need a 16-byte aligned base (``aligned``).  The bulk route
    takes rows of a multiple of 16 bytes, each consumer thread owning one
    16-byte vector of a row; the packed route, for C < V = 16 / esize
    dividing V and S * C (``_walk_route``'s packed rows), reads a sample as
    S * C / V vectors, one row each, lane k on channel k % C.  Any other
    shape takes the register path.  The grid aims at ``_BLOCKS_PER_SM``
    blocks per SM over all samples, but never below ``_MIN_BLOCK_BYTES`` of
    input per block.
    """
    walk, _, row = _walk_route(s, c, esize, aligned)
    if walk == "vector" and c * esize // 16 <= _CONSUMERS:
        route = "bulk"
    elif walk == "packed":
        route = "packed"
    else:
        route, row = "register", c
    rows = s * c // row
    row_bytes = row * esize
    per_sample = max(1, min(-(-_BLOCKS_PER_SM * sms // n),
                            -(-rows * row_bytes // _MIN_BLOCK_BYTES)))
    rows_per_block = max(1, -(-rows // per_sample))
    blocks = max(1, -(-rows // rows_per_block))
    return MomentsPlan(route, blocks, rows_per_block,
                       0 if route == "register" else _STAGE_BYTES // row_bytes)


def _tickets(device: torch.device, n: int, pool=_TICKETS) -> torch.Tensor:
    t = pool.get(device)
    if t is None or t.numel() < n:
        t = torch.zeros(max(n, 64), dtype=torch.int32, device=device)
        pool[device] = t
    return t


def _group_norm_moments_cuda(x, num_groups, weight, eps, fold=True):
    """One launch of ``gn_moments_kernel``: the folded statistics, or with
    ``fold`` off the (2, N, C) sums (``weight`` and ``eps`` unused)."""
    global STATS_LAUNCHES
    _build.require_cuda(x, "group_norm_moments")
    _check_activation(x, "group_norm_moments")
    n, c = x.shape[:2]
    s = x.numel() // (n * c) if n * c else 0
    gamma = None
    if fold:
        gamma = weight.float().contiguous()
        if gamma.shape != (c,) or gamma.device != x.device:
            raise ValueError("group_norm_moments: weight must be (C,) on x's device")
        out = [torch.empty((n, c), dtype=torch.float32, device=x.device) for _ in range(3)]
        ptrs = [t.data_ptr() for t in out]
    else:
        sums = torch.empty((2, n, c), dtype=torch.float32, device=x.device)
        ptrs = [sums[0].data_ptr(), sums[1].data_ptr(), None]
    if n * c and s:
        plan = plan_moments(n, s, c, x.element_size(), x.data_ptr() % 16 == 0,
                            torch.cuda.get_device_properties(x.device).multi_processor_count)
        part = torch.empty((n, plan.blocks, 2, c), dtype=torch.float32, device=x.device)
        fn = _build.kernel("tmt_gn_moments", _MOMENTS_ARGS)
        err = fn(x.data_ptr(), _build.DTYPE_CODES[x.dtype], n, s, c, num_groups,
                 None if gamma is None else gamma.data_ptr(), eps, plan.blocks,
                 plan.rows_per_block, MOMENTS_ROUTES.index(plan.route), plan.stage_rows,
                 part.data_ptr(), _tickets(x.device, n).data_ptr(), *ptrs, int(fold),
                 _build.stream_of(x))
        _build.check(err, "tmt_gn_moments")
        STATS_LAUNCHES += 1
    elif not fold:
        sums.zero_()
    return GroupNormStats(*out) if fold else sums


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


def group_norm_sums(x: torch.Tensor) -> torch.Tensor:
    """K1 moments with the fold off: (2, N, C) fp32 per-(n, c) sum and sum
    of squares of one slab, to be added over the slabs of a volume before
    ``fold_group_stats``.  On CUDA one launch of ``gn_moments_kernel``."""
    if x.device.type == "cpu":
        return torch.stack(group_norm_stats_plain(x))
    return _group_norm_moments_cuda(x, 1, None, 0.0, fold=False)


@torch.library.custom_op("tpu_mednet_torch::gn_moments", mutates_args=(),
                         device_types=("cpu", "cuda"))
def _gn_moments_op(x: Tensor, num_groups: int, weight: Tensor,
                   eps: float) -> Tuple[Tensor, Tensor, Tensor]:
    return tuple(group_norm_moments(x, num_groups, weight, eps))


@_gn_moments_op.register_fake
def _gn_moments_fake(x, num_groups, weight, eps):
    n, c = x.shape[:2]
    return tuple(x.new_empty((n, c), dtype=torch.float32) for _ in range(3))


# -- normalize + affine (+ residual) (+ act) --------------------------------

def group_norm_apply_plain(x: torch.Tensor, mean_c: torch.Tensor,
                           mul_c: torch.Tensor, bias: torch.Tensor,
                           residual: Optional[torch.Tensor] = None,
                           act: Optional[str] = None,
                           slope: float = LEAKY_SLOPE) -> torch.Tensor:
    """fp32 ``act((x - mean) * mul + beta (+ residual))``, rounded once."""
    n, c = mean_c.shape
    y = (x.float() - mean_c.view(n, c, 1, 1, 1)) * mul_c.view(n, c, 1, 1, 1)
    y = y + bias.float().view(1, c, 1, 1, 1)
    if residual is not None:
        y = y + residual.float()
    y = activation_plain(y, act, slope)
    return y.to(x.dtype).contiguous(memory_format=CL3D)


class ApplyPlan(NamedTuple):
    """How ``gn_apply_kernel`` and ``gn_bwd_apply_kernel`` walk one shape."""

    route: str            # "vector", "packed" or "scalar" (APPLY_ROUTES)
    vec: int              # elements per access: 16 / esize, or 1 (scalar)
    row: int              # elements per row: C, or one vector (packed)
    rows: int             # rows per sample
    chunk: int            # vectors of a row per block
    chunks: int           # blocks across a row (grid z)
    threads: int          # chunk * row slots
    blocks: int           # blocks per sample (grid x)
    rows_per_block: int


def _walk_route(s: int, c: int, esize: int, aligned: bool) -> Tuple[str, int, int]:
    """(route, elements an access, elements a row) of the walks the apply
    kernels and the backward reduce share (``plan_apply``)."""
    wide = 16 // esize
    if aligned and c % wide == 0:
        return "vector", wide, c
    if aligned and c < wide and wide % c == 0 and s * c % wide == 0:
        return "packed", wide, wide
    return "scalar", 1, c


@functools.lru_cache(maxsize=256)
def plan_apply(n: int, s: int, c: int, esize: int, aligned: bool, sms: int) -> ApplyPlan:
    """Launch plan of both apply kernels for N samples of S rows of C
    channels of ``esize`` bytes.

    The vector route reads a row as C / V 16-byte vectors (V = 16 / esize);
    the packed route, for C < V dividing V and S * C, reads V / C rows as
    one vector, so every lane keeps channel ``lane % C``; both need a
    16-byte aligned base (``aligned``).  Any other shape takes the scalar
    route, one element a thread and row.  A block holds whole row slots of
    ``chunk`` vectors (full warps where a multiple of 32 threads fits in
    ``_APPLY_THREADS``); rows per block are sized so the grid has about
    ``_APPLY_BLOCKS_PER_SM`` blocks per SM, each thread taking
    ``_APPLY_ROWS`` to ``_APPLY_MAX_ROWS`` rows.
    """
    route, vec, row = _walk_route(s, c, esize, aligned)
    rows = s * c // row
    vecs = row // vec
    chunk = -(-vecs // -(-vecs // _APPLY_MAX_THREADS))
    chunks = -(-vecs // chunk)
    fit = max(1, _APPLY_THREADS // chunk)
    slots = next((k for k in range(fit, 0, -1) if chunk * k % 32 == 0), fit)
    per_sample = max(1, -(-_APPLY_BLOCKS_PER_SM * sms // (n * chunks)))
    step = slots * _APPLY_ROWS
    rows_per_block = min(max(step, -(-rows // per_sample // step) * step),
                         slots * _APPLY_MAX_ROWS)
    return ApplyPlan(route, vec, row, rows, chunk, chunks, chunk * slots,
                     -(-rows // rows_per_block), rows_per_block)


def _plan_fields(plan: ApplyPlan) -> tuple:
    """The plan as the C entries take it (route, blocks, rows per block,
    threads, chunk)."""
    return (APPLY_ROUTES.index(plan.route), plan.blocks, plan.rows_per_block,
            plan.threads, plan.chunk)


class ReducePlan(NamedTuple):
    """How ``gn_bwd_reduce_kernel`` walks one shape: ``plan_apply``'s
    walk, and rows a ring stage (0: the walk streams from device memory)."""

    route: str            # "vector", "packed" or "scalar" (APPLY_ROUTES)
    vec: int              # elements per access: 16 / esize, or 1 (scalar)
    row: int              # elements per row: C, or one vector (packed)
    rows: int             # rows per sample
    chunk: int            # vectors of a row per block
    chunks: int           # blocks across a row (grid z)
    threads: int          # chunk * row slots (the ring adds a producer warp)
    blocks: int           # blocks per sample (grid x)
    rows_per_block: int
    stage_rows: int       # rows of one ring stage of each operand, or 0


@functools.lru_cache(maxsize=256)
def plan_bwd_reduce(n: int, s: int, c: int, esize: int, aligned: bool, sms: int,
                    operands: int = 2, ring: Optional[bool] = None,
                    act: Optional[str] = "e") -> ReducePlan:
    """Launch plan of the backward reduce for N samples of S rows of C
    channels of ``esize`` bytes, ``operands`` tensors read (x, dy and the
    residual where there is one).

    Routes as ``plan_apply``'s.  A block holds at most ``_REDUCE_CHUNK``
    vectors of a row (grid z over the rest) in whole row slots of
    ``_REDUCE_THREADS`` threads.  The grid is one wave: as many blocks as
    the card holds at once (``_RING_BLOCKS_PER_SM`` or
    ``_WALK_BLOCKS_PER_SM`` an SM), each rows_per_block rows in whole
    steps of ``_REDUCE_ROWS`` rows a thread, so every block reads about as
    much and the sample's last block alone adds a tail.  The ring needs
    one chunk across the row, threads in whole warps and a 16-byte route;
    its ``_RING_STAGES`` stages of every operand hold ``_RING_BYTES``
    together, each a whole number of rows a row slot.  ``ring`` None takes
    it where a block would stream at least ``_RING_MIN_STAGES`` stages
    (``act`` ELU) or ``_RING_MIN_STAGES_CHEAP_ACT`` (any other).
    """
    route, vec, row = _walk_route(s, c, esize, aligned)
    rows = s * c // row
    vecs = row // vec
    chunks = -(-vecs // _REDUCE_CHUNK)
    chunk = -(-vecs // chunks)
    fit = max(1, _REDUCE_THREADS // chunk)
    slots = next((k for k in range(fit, 0, -1) if chunk * k % 32 == 0), fit)
    threads = chunk * slots
    can_ring = route != "scalar" and chunks == 1 and threads % 32 == 0
    if ring and not can_ring:
        raise ValueError(f"the ring cannot take {route} rows of {c} channels")
    step = slots * _REDUCE_ROWS

    def plan(per_sm, stage_rows):
        per_sample = max(1, per_sm * sms // (n * chunks))
        rows_per_block = max(step, -(-rows // per_sample // step) * step)
        return ReducePlan(route, vec, row, rows, chunk, chunks, threads,
                          -(-rows // rows_per_block), rows_per_block, stage_rows)

    walk = plan(_WALK_BLOCKS_PER_SM, 0)
    if not can_ring or ring is False:
        return walk
    stage_rows = _RING_BYTES // (_RING_STAGES * operands * row * esize)
    stage_rows = stage_rows // slots * slots or max(1, stage_rows)
    with_ring = plan(_RING_BLOCKS_PER_SM, stage_rows)
    least = _RING_MIN_STAGES if act == "e" else _RING_MIN_STAGES_CHEAP_ACT
    if ring or with_ring.rows_per_block >= least * stage_rows:
        return with_ring
    return walk


def _reduce_fields(plan: ReducePlan) -> tuple:
    """The reduce plan as the C entries take it (route, blocks, rows per
    block, threads, chunk, rows a ring stage)."""
    return (APPLY_ROUTES.index(plan.route), plan.blocks, plan.rows_per_block,
            plan.threads, plan.chunk, plan.stage_rows)


def _aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy where its data is not 16-byte aligned (the vector
    route loads statistics 16 bytes at a time)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _apply_plan(x: torch.Tensor, *others: Optional[torch.Tensor]) -> ApplyPlan:
    n, c = x.shape[:2]
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, *others) if t is not None)
    return plan_apply(n, x.numel() // (n * c), c, x.element_size(), aligned,
                      torch.cuda.get_device_properties(x.device).multi_processor_count)


def _group_norm_apply_cuda(x, mean_c, mul_c, bias, residual=None, act=None,
                           slope=LEAKY_SLOPE):
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
    mean_c = _aligned16(mean_c.float().contiguous())
    mul_c = _aligned16(mul_c.float().contiguous())
    beta = _aligned16(bias.float().contiguous())
    if mean_c.shape != (n, c) or mul_c.shape != (n, c) or beta.shape != (c,):
        raise ValueError("group_norm_apply: mean/mul must be (N, C), bias (C,)")
    for t in (mean_c, mul_c, beta):
        if t.device != x.device:
            raise ValueError("group_norm_apply: statistics on another device")
    y = torch.empty_like(x, memory_format=CL3D)
    plan = _apply_plan(x, residual, y)
    fn = _build.kernel("tmt_gn_apply", _APPLY_ARGS)
    err = fn(x.data_ptr(), None if residual is None else residual.data_ptr(),
             y.data_ptr(), mean_c.data_ptr(), mul_c.data_ptr(), beta.data_ptr(),
             _build.DTYPE_CODES[x.dtype], n, x.numel() // (n * c), c,
             ACT_CODES[act], slope, *_plan_fields(plan), _build.stream_of(x))
    _build.check(err, "tmt_gn_apply")
    APPLY_LAUNCHES += 1
    return y


def group_norm_apply(x: torch.Tensor, mean_c: torch.Tensor, mul_c: torch.Tensor,
                     bias: torch.Tensor, residual: Optional[torch.Tensor] = None,
                     act: Optional[str] = None, slope: float = LEAKY_SLOPE) -> torch.Tensor:
    """K1 apply: ``act((x - mean) * mul + beta (+ residual))`` in x's dtype
    (``slope``: LeakyReLU's)."""
    if act not in ACT_CODES:
        raise ValueError(f"unknown nonlinearity {act!r}")
    if x.device.type == "cpu":
        return group_norm_apply_plain(x, mean_c, mul_c, bias, residual, act, slope)
    return _group_norm_apply_cuda(x, mean_c, mul_c, bias, residual, act, slope)


@torch.library.custom_op("tpu_mednet_torch::gn_apply", mutates_args=(),
                         device_types=("cpu", "cuda"))
def _gn_apply_op(x: Tensor, mean_c: Tensor, mul_c: Tensor, bias: Tensor,
                 residual: Optional[Tensor], act: Optional[str],
                 slope: float = LEAKY_SLOPE) -> Tensor:
    return group_norm_apply(x, mean_c, mul_c, bias, residual, act, slope)


@_gn_apply_op.register_fake
def _gn_apply_fake(x, mean_c, mul_c, bias, residual, act, slope=LEAKY_SLOPE):
    return torch.empty_like(x, memory_format=CL3D)


def group_norm_plain(x: torch.Tensor, num_groups: int, weight: torch.Tensor,
                     bias: torch.Tensor, eps: float = 1e-5,
                     residual: Optional[torch.Tensor] = None,
                     act: Optional[str] = None, slope: float = LEAKY_SLOPE) -> torch.Tensor:
    """The plain forward on any device, differentiated by torch autograd:
    the reference the kernels and the closed-form backward are held to."""
    stats = group_norm_moments_plain(x, num_groups, weight, eps)
    return group_norm_apply_plain(x, stats.mean, stats.mul, bias, residual, act, slope)


# -- backward -----------------------------------------------------------------

def activation_grad_plain(z: torch.Tensor, act: Optional[str],
                          slope: float = LEAKY_SLOPE) -> torch.Tensor:
    """act'(z) in fp32, as torch's own backward of each nonlinearity takes it."""
    if act is None:
        return torch.ones_like(z)
    if act == "r":
        return (z > 0).to(z.dtype)
    if act == "l":
        return torch.where(z > 0, 1.0, slope).to(z.dtype)
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
                              act: Optional[str] = None,
                              slope: float = LEAKY_SLOPE) -> GroupNormGrads:
    """The closed-form backward of ``group_norm`` in fp32 torch ops.

    With z the forward's pre-activation, dz = dy * act'(z) and
    xhat = (x - mean) * rstd, per (n, c): A = sum dz, B = sum dz * xhat;
    dbias = sum_n A, dweight = sum_n B, dresidual = dz and
    dx = mul * dz + coeff_b * (x - mean) + coeff_c with, per group,
    coeff_b = -rstd^2 * sum(gamma B) / M, coeff_c = -rstd * sum(gamma A) / M
    (M = elements per group).  The kernels compute the same, in this order,
    except that the reduce sums B as rstd * sum dz * (x - mean).
    """
    xm, mul, dz, coef = backward_terms_plain(x, dy, mean_c, rstd_c, weight, bias,
                                             num_groups, residual, act, slope)
    dx, dr = _backward_apply_plain(x, xm, mul, dz, coef, residual)
    return GroupNormGrads(dx, coef[1].sum(0).to(weight.dtype), coef[0].sum(0).to(bias.dtype),
                          dr)


def _backward_apply_plain(x, xm, mul, dz, coef, residual):
    """dx = mul * dz + coeff_b * (x - mean) + coeff_c, and dr = dz, in x's
    dtype."""
    view = (*mul.shape, 1, 1, 1)
    dx = mul.view(view) * dz + coef[2].view(view) * xm + coef[3].view(view)
    dr = None if residual is None else dz.to(x.dtype).contiguous(memory_format=CL3D)
    return dx.to(x.dtype).contiguous(memory_format=CL3D), dr


def backward_terms_plain(x: torch.Tensor, dy: torch.Tensor, mean_c: torch.Tensor,
                         rstd_c: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                         num_groups: int, residual: Optional[torch.Tensor] = None,
                         act: Optional[str] = None, slope: float = LEAKY_SLOPE):
    """fp32 (x - mean, mul = rstd * gamma (N, C), dz, coef) of
    ``group_norm_backward_plain``; coef (4, N, C) holds A, B, coeff_b and
    coeff_c, as the reduce kernel's output does."""
    xm, mul, dz, a, b = backward_sums_plain(x, dy, mean_c, rstd_c, weight, bias,
                                            residual, act, slope)
    n, c = mean_c.shape
    count = (x.numel() // max(1, n * c)) * (c // num_groups)
    coeff_b, coeff_c = backward_coefficients(a, b, rstd_c, weight, num_groups, count)
    return xm, mul, dz, torch.stack((a, b, coeff_b, coeff_c))


def backward_sums_plain(x: torch.Tensor, dy: torch.Tensor, mean_c: torch.Tensor,
                        rstd_c: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                        residual: Optional[torch.Tensor] = None,
                        act: Optional[str] = None, slope: float = LEAKY_SLOPE):
    """fp32 (x - mean, mul, dz, A, B) of the backward, before the group fold."""
    n, c = mean_c.shape
    view = (n, c, 1, 1, 1)
    # the forward's z, each operation rounded as in the forward
    xm = x.float() - mean_c.view(view)
    mul = rstd_c * weight.float()
    z = xm * mul.view(view) + bias.float().view(1, c, 1, 1, 1)
    if residual is not None:
        z = z + residual.float()
    dz = dy.float() * activation_grad_plain(z, act, slope)
    del z
    a = dz.sum(dim=(2, 3, 4))
    b = (dz * (xm * rstd_c.view(view))).sum(dim=(2, 3, 4))
    return xm, mul, dz, a, b


def backward_coefficients(a: torch.Tensor, b: torch.Tensor, rstd_c: torch.Tensor,
                          weight: torch.Tensor, num_groups: int, count: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """dx's per-(n, c) coefficients from A and B (N, C) over ``count``
    elements a group: coeff_b = -rstd^2 * sum_g(gamma B) / M and
    coeff_c = -rstd * sum_g(gamma A) / M."""
    n, c = a.shape
    cg = c // num_groups
    gw = weight.float()
    sa = (gw * a).view(n, num_groups, cg).sum(-1).repeat_interleave(cg, dim=1)
    sb = (gw * b).view(n, num_groups, cg).sum(-1).repeat_interleave(cg, dim=1)
    return -(rstd_c * rstd_c * sb / count), -(rstd_c * sa / count)


def _backward_inputs(x, dy, mean_c, rstd_c, weight, bias, residual):
    """The backward kernels' checked operands: fp32 16-byte aligned
    (mean, rstd, gamma, beta)."""
    _build.require_cuda(x, "group_norm_backward")
    _check_activation(x, "group_norm_backward")
    for t, what in ((dy, "dy"), (residual, "residual")):
        if t is not None and (t.shape != x.shape or t.dtype != x.dtype
                              or t.device != x.device
                              or not t.is_contiguous(memory_format=CL3D)):
            raise ValueError(f"group_norm_backward: {what} must match x in shape, "
                             "dtype, device and channels_last_3d layout")
    n, c = x.shape[:2]
    small = [t.float().contiguous() for t in (mean_c, rstd_c, weight, bias)]
    if any(t.device != x.device for t in small) or small[0].shape != (n, c) \
            or small[1].shape != (n, c) or small[2].shape != (c,) or small[3].shape != (c,):
        raise ValueError("group_norm_backward: mean/rstd must be (N, C) and "
                         "weight/bias (C,) on x's device")
    return tuple(_aligned16(t) for t in small)


def reduce_plan(x: torch.Tensor, dy: torch.Tensor,
                residual: Optional[torch.Tensor] = None, act: Optional[str] = "e",
                **kw) -> ReducePlan:
    """``plan_bwd_reduce`` for the reduce's operands and nonlinearity on
    their card (``kw``: ``ring``)."""
    n, c = x.shape[:2]
    ops = (x, dy) if residual is None else (x, dy, residual)
    return plan_bwd_reduce(n, x.numel() // (n * c), c, x.element_size(),
                           all(t.data_ptr() % 16 == 0 for t in ops),
                           torch.cuda.get_device_properties(x.device).multi_processor_count,
                           len(ops), act=act, **kw)


def reduce_info(x: torch.Tensor, num_groups: int, plan: ReducePlan,
                residual: bool = False) -> Dict[str, int]:
    """The reduce kernel's instance for ``plan`` on x's card: registers a
    thread, blocks an SM holds and dynamic shared memory a block."""
    n, c = x.shape[:2]
    info = (ctypes.c_int * 3)()
    fn = _build.kernel("tmt_gn_bwd_reduce_info", _REDUCE_INFO_ARGS)
    _build.check(fn(_build.DTYPE_CODES[x.dtype], n, x.numel() // (n * c), c, num_groups,
                    int(residual), *_reduce_fields(plan), ctypes.addressof(info)),
                 "tmt_gn_bwd_reduce_info")
    return dict(registers=info[0], blocks_per_sm=info[1], smem_bytes=info[2])


def _bwd_reduce_cuda(x, dy, stats, num_groups, residual, act, fold=True, plan=None,
                     slope=LEAKY_SLOPE):
    """One launch of ``gn_bwd_reduce_kernel`` (``plan``: ``reduce_plan``'s
    unless given): (4, N, C) A, B, coeff_b, coeff_c, or with ``fold`` off
    (2, N, C) A and B."""
    global BWD_REDUCE_LAUNCHES
    n, c = x.shape[:2]
    s = x.numel() // (n * c)
    mean_c, rstd_c, gamma, beta = stats
    plan = plan or reduce_plan(x, dy, residual, act)
    part = torch.empty((n, plan.blocks, 2, c), dtype=torch.float32, device=x.device)
    coef = torch.empty((4 if fold else 2, n, c), dtype=torch.float32, device=x.device)
    fn = _build.kernel("tmt_gn_bwd_reduce", _BWD_REDUCE_ARGS)
    err = fn(x.data_ptr(), dy.data_ptr(), None if residual is None else residual.data_ptr(),
             _build.DTYPE_CODES[x.dtype], n, s, c, num_groups, mean_c.data_ptr(),
             rstd_c.data_ptr(), gamma.data_ptr(), beta.data_ptr(), ACT_CODES[act],
             slope, *_reduce_fields(plan), part.data_ptr(),
             _tickets(x.device, n, _BWD_TICKETS).data_ptr(), coef.data_ptr(), int(fold),
             _build.stream_of(x))
    _build.check(err, "tmt_gn_bwd_reduce")
    BWD_REDUCE_LAUNCHES += 1
    return coef


def _bwd_apply_cuda(x, dy, stats, coef, residual, act, slope=LEAKY_SLOPE):
    """One launch of ``gn_bwd_apply_kernel`` from coef (4, N, C): dx, and
    the residual's gradient where there is one."""
    global BWD_APPLY_LAUNCHES
    n, c = x.shape[:2]
    mean_c, rstd_c, gamma, beta = stats
    dx = torch.empty_like(x, memory_format=CL3D)
    dr = None if residual is None else torch.empty_like(x, memory_format=CL3D)
    fn = _build.kernel("tmt_gn_bwd_apply", _BWD_APPLY_ARGS)
    err = fn(x.data_ptr(), dy.data_ptr(), None if residual is None else residual.data_ptr(),
             dx.data_ptr(), None if dr is None else dr.data_ptr(),
             _build.DTYPE_CODES[x.dtype], n, x.numel() // (n * c), c, mean_c.data_ptr(),
             rstd_c.data_ptr(), gamma.data_ptr(), beta.data_ptr(), coef.data_ptr(),
             ACT_CODES[act], slope,
             *_plan_fields(_apply_plan(x, dy, residual, dx, dr)), _build.stream_of(x))
    _build.check(err, "tmt_gn_bwd_apply")
    BWD_APPLY_LAUNCHES += 1
    return dx, dr


def _group_norm_backward_cuda(x, dy, mean_c, rstd_c, weight, bias, num_groups,
                              residual=None, act=None, slope=LEAKY_SLOPE):
    stats = _backward_inputs(x, dy, mean_c, rstd_c, weight, bias, residual)
    coef = _bwd_reduce_cuda(x, dy, stats, num_groups, residual, act, slope=slope)
    dx, dr = _bwd_apply_cuda(x, dy, stats, coef, residual, act, slope)
    return GroupNormGrads(dx, coef[1].sum(0).to(weight.dtype),
                          coef[0].sum(0).to(bias.dtype), dr)


def group_norm_backward(x: torch.Tensor, dy: torch.Tensor, mean_c: torch.Tensor,
                        rstd_c: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                        num_groups: int, residual: Optional[torch.Tensor] = None,
                        act: Optional[str] = None, slope: float = LEAKY_SLOPE
                        ) -> GroupNormGrads:
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
                                         num_groups, residual, act, slope)
    return _group_norm_backward_cuda(x, dy, mean_c, rstd_c, weight, bias,
                                     num_groups, residual, act, slope)


class GroupNormFunction(torch.autograd.Function):
    """``group_norm`` under autograd: K1's forward kernels, and K1's
    backward kernels for the gradient.  Saves x, the residual and the
    per-(n, c) mean and rstd; z is recomputed in the backward.  ``slope``,
    LeakyReLU's, may be left out (``LEAKY_SLOPE``)."""

    @staticmethod
    def forward(ctx, x, weight, bias, residual, num_groups, eps, act, slope=LEAKY_SLOPE):
        stats = group_norm_moments(x, num_groups, weight, eps)
        y = group_norm_apply(x, stats.mean, stats.mul, bias, residual, act, slope)
        ctx.save_for_backward(x, weight, bias, residual, stats.mean, stats.rstd)
        ctx.num_groups, ctx.act, ctx.slope = num_groups, act, slope
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, bias, residual, mean_c, rstd_c = ctx.saved_tensors
        dy = dy.contiguous(memory_format=CL3D)
        g = group_norm_backward(x, dy, mean_c, rstd_c, weight, bias, ctx.num_groups,
                                residual, ctx.act, ctx.slope)
        return g.dx, g.dweight, g.dbias, g.dresidual, None, None, None, None


def group_norm_backward_sums(x: torch.Tensor, dy: torch.Tensor, mean_c: torch.Tensor,
                             rstd_c: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                             num_groups: int, residual: Optional[torch.Tensor] = None,
                             act: Optional[str] = None,
                             slope: float = LEAKY_SLOPE) -> torch.Tensor:
    """K1's backward reduce with the fold off: (2, N, C) fp32 A = sum dz and
    B = sum dz * xhat of one slab, to be added over the slabs of a volume
    before ``backward_coefficients``.  On CUDA one launch of
    ``gn_bwd_reduce_kernel``."""
    if act not in ACT_CODES:
        raise ValueError(f"unknown nonlinearity {act!r}")
    if x.device.type == "cpu":
        *_, a, b = backward_sums_plain(x, dy, mean_c, rstd_c, weight, bias, residual, act,
                                       slope)
        return torch.stack((a, b))
    stats = _backward_inputs(x, dy, mean_c, rstd_c, weight, bias, residual)
    return _bwd_reduce_cuda(x, dy, stats, num_groups, residual, act, fold=False, slope=slope)


def group_norm_backward_apply(x: torch.Tensor, dy: torch.Tensor, mean_c: torch.Tensor,
                              rstd_c: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                              coef: torch.Tensor, residual: Optional[torch.Tensor] = None,
                              act: Optional[str] = None, slope: float = LEAKY_SLOPE
                              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """K1's backward apply from coef (4, N, C) = (A, B, coeff_b, coeff_c):
    dx and the residual's gradient (None without a residual).  On CUDA one
    launch of ``gn_bwd_apply_kernel``."""
    if x.device.type == "cpu":
        xm, mul, dz, _, _ = backward_sums_plain(x, dy, mean_c, rstd_c, weight, bias,
                                                residual, act, slope)
        return _backward_apply_plain(x, xm, mul, dz, coef, residual)
    stats = _backward_inputs(x, dy, mean_c, rstd_c, weight, bias, residual)
    return _bwd_apply_cuda(x, dy, stats, coef.contiguous(), residual, act, slope)


class SlabGroupNormFunction(torch.autograd.Function):
    """``group_norm`` of one X slab of a volume split over ranks, whose
    statistics are the whole volume's: the moments kernel stops at the
    slab's sums, ``reduce`` adds them over the slab's ranks in place, and
    the fold takes ``spatial``, the volume's rows a sample; in the
    backward, A and B are added likewise before dx's coefficients.
    dweight and dbias are this slab's share, as every parameter gradient of
    a rank is (``DataMesh.average_gradients`` sums them).  Still one launch
    of each of K1's four kernels."""

    @staticmethod
    def forward(ctx, x, weight, bias, residual, num_groups, eps, act, reduce, spatial,
                slope=LEAKY_SLOPE):
        sums = group_norm_sums(x)
        reduce(sums)
        stats = fold_group_stats(sums[0], sums[1], spatial, num_groups, weight, eps)
        y = group_norm_apply(x, stats.mean, stats.mul, bias, residual, act, slope)
        ctx.save_for_backward(x, weight, bias, residual, stats.mean, stats.rstd)
        ctx.num_groups, ctx.act, ctx.reduce, ctx.slope = num_groups, act, reduce, slope
        ctx.count = spatial * (x.shape[1] // num_groups)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, bias, residual, mean_c, rstd_c = ctx.saved_tensors
        dy = dy.contiguous(memory_format=CL3D)
        ab = group_norm_backward_sums(x, dy, mean_c, rstd_c, weight, bias, ctx.num_groups,
                                      residual, ctx.act, ctx.slope)
        dweight, dbias = ab[1].sum(0).to(weight.dtype), ab[0].sum(0).to(bias.dtype)
        ctx.reduce(ab)
        coeff_b, coeff_c = backward_coefficients(ab[0], ab[1], rstd_c, weight,
                                                 ctx.num_groups, ctx.count)
        dx, dr = group_norm_backward_apply(x, dy, mean_c, rstd_c, weight, bias,
                                           torch.stack((ab[0], ab[1], coeff_b, coeff_c)),
                                           residual, ctx.act, ctx.slope)
        return dx, dweight, dbias, dr, None, None, None, None, None, None


def group_norm(x: torch.Tensor, num_groups: int, weight: torch.Tensor,
               bias: torch.Tensor, eps: float = 1e-5,
               residual: Optional[torch.Tensor] = None,
               act: Optional[str] = None, slope: float = LEAKY_SLOPE) -> torch.Tensor:
    """GroupNorm (+ residual add) (+ nonlinearity, LeakyReLU at ``slope``) of
    a channels_last_3d activation, differentiable: the moments kernel, then
    the apply kernel;
    the backward kernels under autograd.  Where no input needs a gradient
    the forward goes through the two custom ops, which ``torch.export``
    traces; under autograd ``GroupNormFunction`` calls the wrappers
    directly, so training pays no dispatcher time."""
    if x.device.type != "cpu":
        _build.require_cuda(x, "group_norm")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, weight, bias, residual)):
        return GroupNormFunction.apply(x, weight, bias, residual, num_groups, eps, act,
                                       slope)
    ops = torch.ops.tpu_mednet_torch
    mean, mul, _ = ops.gn_moments(x, num_groups, weight, float(eps))
    return ops.gn_apply(x, mean, mul, bias, residual, act, float(slope))
