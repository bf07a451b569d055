"""K1's moments on the CPU: ``plan_moments``' routes and a numpy emulation
of ``gn_moments_kernel``'s packed route (``tpu_mednet_torch/csrc/groupnorm.cu``).

The kernel cannot run here, so the emulation follows it: block (bx, n) of
256 consumer threads, the sample read as S * C / V 16-byte vectors (V = 16
/ esize), one row each; stage by stage of ``stage_rows`` vectors, consumer
t sums vectors t, t + 256, ... of the stage, lane k of its vector in fp32
registers (the square added by one FMA); the block folds each of its 2 V
columns over the 256 slots in segments of consecutive slots (256 / (2 V)
segments, then the segments in order), then channel ch adds its lanes ch,
ch + C, ... in order; the sample's last block adds the partials in block
order, then folds the group (flax's clamped fast variance, rsqrt, times
gamma).

On the packed route a 16-byte vector holds V / C consecutive spatial rows
of C channels: the JAX package's z-packed layout at zb = V / C
(``tpu_mednet/ops/packed.py`` ``pack_z``), whose per-lane moments
``lane_moments_pallas`` computes.  So the emulated sums are held against
``lane_moments_pallas(interpret=True)`` on ``pack_z(x, V / C)`` (fold off:
the per-(n, c) sums) and against ``packed_group_norm_stats`` (fold on:
mean, rstd, mul), at the moments' rtol 1e-5; every element is read once
with its own channel.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_mednet.ops.packed import pack_z, packed_group_norm_stats
from tpu_mednet.ops.pallas.groupnorm import lane_moments_pallas
from tpu_mednet_torch.ops import groupnorm as gn

F32 = np.float32
CONSUMERS = gn._CONSUMERS
SPATIAL = (16, 16, 16)


def _walk(plan: gn.MomentsPlan, s: int, c: int, esize: int):
    """(vector elements, vectors a row, slots, rows[bx, slot, m]) of the
    plan's walk: the m-th row each consumer of a row slot takes, in its
    order (-1 past its last), over the stages of its block's span."""
    wide = 16 // esize
    width = wide if plan.route == "packed" else c
    vec = 1 if plan.route == "register" else wide
    vecs = width // vec
    consumers = CONSUMERS if vecs <= CONSUMERS else -(-vecs // 32) * 32
    slots = consumers // vecs
    rows = s * c // width
    stage = plan.stage_rows or plan.rows_per_block
    per_block = []
    for bx in range(plan.blocks):
        b0 = bx * plan.rows_per_block
        b1 = min(b0 + plan.rows_per_block, rows)
        taken = [[] for _ in range(slots)]
        for r0 in range(b0, b1, stage):
            for slot in range(slots):
                taken[slot] += range(r0 + slot, min(r0 + stage, b1), slots)
        per_block.append(taken)
    m = max(1, max(len(t) for taken in per_block for t in taken))
    out = np.full((plan.blocks, slots, m), -1, np.int64)
    for bx, taken in enumerate(per_block):
        for slot, t in enumerate(taken):
            out[bx, slot, :len(t)] = t
    return vec, vecs, width, out


def _check_coverage(plan, s, c, esize):
    """Every element of a sample read once, each lane on its own channel:
    lane k of the vector on channel k % C (packed), vector cv's lane k on
    cv * V + k (bulk), thread cv on channel cv (register)."""
    vec, vecs, width, rows = _walk(plan, s, c, esize)
    cv, k = np.meshgrid(np.arange(vecs), np.arange(vec), indexing="ij")
    el = rows[..., None, None] * width + (cv * vec + k)       # (bx, slot, m, cv, k)
    live = np.broadcast_to((rows >= 0)[..., None, None], el.shape)
    hits = np.bincount(el[live].ravel(), minlength=s * c)
    assert hits.shape == (s * c,) and (hits == 1).all(), "every element read once"
    lane_ch = (cv * vec + k) % c
    assert (np.broadcast_to(lane_ch, el.shape)[live] == el[live] % c).all()


def _expected_route(s, c, esize, aligned):
    wide = 16 // esize
    if aligned and c % wide == 0 and c // wide <= CONSUMERS:
        return "bulk"
    if aligned and c < wide and wide % c == 0 and s * c % wide == 0:
        return "packed"
    return "register"


# (N, S, C, esize, aligned, route): C < V on the packed route in both
# dtypes at the gcr input's 8 x 96^3 and at small S; the register path at
# C = 12 bf16, at an offset base and where S * C is not a multiple of V
_PLAN_CASES = [
    (8, 96**3, 1, 2, True, "packed"),
    (8, 96**3, 1, 4, True, "packed"),
    (2, 4096, 1, 2, True, "packed"),
    (2, 4096, 2, 2, True, "packed"),
    (2, 4096, 4, 2, True, "packed"),
    (2, 4096, 1, 4, True, "packed"),
    (2, 4096, 2, 4, True, "packed"),
    (2, 210, 12, 2, True, "register"),
    (2, 4096, 1, 2, False, "register"),
    (2, 105, 2, 2, True, "register"),
    (2, 105, 1, 4, True, "register"),
    (2, 4096, 8, 2, True, "bulk"),
]


@pytest.mark.parametrize("case", _PLAN_CASES, ids=lambda c: "-".join(map(str, c)))
def test_plan_moments_routes_cover_every_vector_once(case):
    n, s, c, esize, aligned, route = case
    plan = gn.plan_moments(n, s, c, esize, aligned, 132)
    assert plan.route == route == _expected_route(s, c, esize, aligned)
    width = 16 // esize if route == "packed" else c
    rows = s * c // width
    assert plan.blocks * plan.rows_per_block >= rows > (plan.blocks - 1) * plan.rows_per_block
    assert plan.stage_rows == (0 if route == "register" else gn._STAGE_BYTES // (width * esize))
    if route == "packed":   # sized as bulk: one wave, at least 64 KB a block
        assert plan.stage_rows == 1024
        assert plan.blocks <= max(1, -(-gn._BLOCKS_PER_SM * 132 // n))
        if plan.blocks > 1:
            assert rows * 16 >= (plan.blocks - 1) * gn._MIN_BLOCK_BYTES
    if s * c <= 4096 * 4 or route == "packed":
        _check_coverage(plan, s, c, esize)


def emulate_packed_moments(plan: gn.MomentsPlan, x: np.ndarray, c: int, esize: int,
                           groups: int, gamma: np.ndarray, eps: float, fold: bool):
    """The packed route's (mean, mul, rstd) or, with ``fold`` off, (2, N, C)
    sums, fp32 in the kernel's order, from x (N, S * C) in memory order."""
    assert plan.route == "packed"
    n = x.shape[0]
    s = x.shape[1] // c
    _, _, width, rows = _walk(plan, s, c, esize)
    vecs = x.reshape(n, -1, width)
    live = (rows >= 0)[..., None]
    count = F32(s * (c // groups))
    cols = 2 * width
    segs = max(1, min(CONSUMERS // cols, CONSUMERS))
    per = -(-CONSUMERS // segs)
    out = np.zeros((3, n, c) if fold else (2, n, c), F32)
    for i in range(n):
        sm = np.zeros(rows.shape[:2] + (width,), F32)             # (bx, slot, lane)
        sq = np.zeros_like(sm)
        for m in range(rows.shape[2]):
            v = np.where(live[:, :, m], vecs[i][np.maximum(rows[:, :, m], 0)], F32(0))
            sm = (sm + v).astype(F32)
            sq = (sq.astype(np.float64) + v.astype(np.float64) ** 2).astype(F32)  # FMA
        red = np.stack((sm, sq), 1)                                # (bx, 2, slot, lane)
        seg = np.zeros((plan.blocks, segs, 2, width), F32)
        for sg in range(segs):
            for k in range(sg * per, min(CONSUMERS, (sg + 1) * per)):
                seg[:, sg] = (seg[:, sg] + red[:, :, k]).astype(F32)
        col = np.zeros((plan.blocks, 2, width), F32)
        for sg in range(segs):
            col = (col + seg[:, sg]).astype(F32)
        part = np.zeros((plan.blocks, 2, c), F32)
        for ch in range(c):
            for lane in range(ch, width, c):
                part[:, :, ch] = (part[:, :, ch] + col[:, :, lane]).astype(F32)
        tot = part[0]
        if plan.blocks > 1:
            tot = np.zeros((2, c), F32)
            for bx in range(plan.blocks):
                tot = (tot + part[bx]).astype(F32)
        if not fold:
            out[:, i] = tot
            continue
        cg = c // groups
        for g in range(groups):
            a = b = F32(0)
            for j in range(g * cg, (g + 1) * cg):
                a, b = F32(a + tot[0, j]), F32(b + tot[1, j])
            mean = F32(a / count)
            var = max(F32(0), F32(F32(b / count) - F32(mean * mean)))
            rstd = F32(1.0 / np.sqrt(np.float64(F32(var + F32(eps)))))
            out[0, i, g * cg:(g + 1) * cg] = mean
            out[1, i, g * cg:(g + 1) * cg] = (rstd * gamma[g * cg:(g + 1) * cg]).astype(F32)
            out[2, i, g * cg:(g + 1) * cg] = rstd
    return out


def _plans(s, c, esize):
    """The planner's plan on a 132-SM card (one block a sample here) and
    a split of it: three blocks a sample, stages of 64 vectors."""
    plan = gn.plan_moments(2, s, c, esize, True, 132)
    rows = s * c * esize // 16
    rpb = -(-rows // 3)
    return [plan, plan._replace(stage_rows=64, rows_per_block=rpb, blocks=-(-rows // rpb))]


# (C, groups, dtype): the packed route's channel counts in both dtypes
_EMULATE_CASES = [(1, 1, torch.bfloat16), (2, 1, torch.bfloat16), (4, 2, torch.bfloat16),
                  (1, 1, torch.float32), (2, 2, torch.float32)]


@pytest.mark.parametrize("fold", [True, False])
@pytest.mark.parametrize("case", _EMULATE_CASES,
                         ids=lambda c: f"c{c[0]}-g{c[1]}-{str(c[2])[6:]}")
def test_emulated_packed_moments_match_jax_lane_moments(case, fold):
    c, groups, dtype = case
    esize = torch.tensor([], dtype=dtype).element_size()
    zb = 16 // esize // c
    rng = np.random.default_rng(c + esize)
    x = rng.normal(0.4, 1.0, (2, *SPATIAL, c)).astype(F32)
    x = torch.from_numpy(x).to(dtype).float().numpy()          # the values x holds
    gamma = (rng.random(c) + 0.5).astype(F32)
    xp = pack_z(jnp.asarray(x).astype(jnp.bfloat16 if dtype == torch.bfloat16
                                      else jnp.float32), zb)
    if fold:
        mean, var = packed_group_norm_stats(xp, zb, groups)
        cg = c // groups
        mean = np.repeat(np.asarray(mean), cg, axis=1)
        rstd = np.repeat(1.0 / np.sqrt(np.maximum(np.asarray(var, np.float64), 0) + 1e-5),
                         cg, axis=1)
        ref = np.stack((mean, rstd * gamma, rstd))
    else:
        lanes = [np.asarray(t).reshape(2, zb, c).sum(1)
                 for t in lane_moments_pallas(xp, interpret=True)]
        ref = np.stack(lanes)
    s = int(np.prod(SPATIAL))
    for plan in _plans(s, c, esize):
        got = emulate_packed_moments(plan, x.reshape(2, -1), c, esize, groups, gamma, 1e-5,
                                     fold)
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=0)
