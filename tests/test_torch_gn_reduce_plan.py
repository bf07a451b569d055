"""K1's backward reduce on the CPU: ``plan_bwd_reduce`` and a numpy
emulation of ``gn_bwd_reduce_kernel``'s walk and fixed-order sums
(``tpu_mednet_torch/csrc/groupnorm.cu``) on the vector, packed and scalar
routes, on the walk and on the ring.

The kernel cannot run here, so the emulation follows it: block (bx, n, z)
of ``threads`` threads; thread t owns channel vector z * chunk + t % chunk
in row slot t / chunk; on the walk it takes rows slot, slot + slots, ... of
the block's span, on the ring the rows of each stage of ``stage_rows`` rows
in that order; lane i keeps channel (vector * V + i) % C.  Each thread sums
dz and dz * (x - mean) per lane in fp32 in that order; the block folds its
row slots in segments of consecutive slots (then the segments), the lanes
of a channel in lane order; the sample's last
block adds the partials in block order (segments of blocks, then the
segments), and folds each group over 32 warp lanes and a butterfly.

Each case asserts that every element is read once with its own (n, c), and
that the emulated A, B, coeff_b and coeff_c lie within 1e-5 x max |ref| of
``backward_terms_plain``'s, both in fp32 and with its sums taken in
float64 (other fp32 summation orders).  The emulated coefficients then go
through ``_backward_apply_plain`` and are held against ``jax.vjp`` of flax
GroupNorm (+ residual, + nonlinearity) within PR 3's CPU bound: fp32,
1e-5 x max |ref| per output.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from test_torch_kernels_cuda import _BWD_CASES, float64_sums
from test_torch_kernels_cuda import _activation as _card_activation
from tpu_mednet_torch.ops import groupnorm as gn

CL3D = torch.channels_last_3d
SPATIAL = (4, 5, 6)        # S = 120: S * C a multiple of 8 at every C
ODD_SPATIAL = (3, 5, 7)    # S = 105: the packed route refuses it
_ACTS = (None, "e", "r", "l")
_FLAX_ACT = {None: lambda v: v, "e": nn.elu, "r": nn.relu,
             "l": lambda v: nn.leaky_relu(v, negative_slope=0.1)}
F32 = np.float32


def _expected_route(c, esize, aligned, s):
    wide = 16 // esize
    if aligned and c % wide == 0:
        return "vector"
    if aligned and c < wide and wide % c == 0 and s * c % wide == 0:
        return "packed"
    return "scalar"


def _thread_rows(plan: gn.ReducePlan):
    """rows[bx, slot, m]: the m-th row a thread of row slot ``slot`` in
    block bx takes, in its order (-1 past its last)."""
    slots = plan.threads // plan.chunk
    out = []
    for bx in range(plan.blocks):
        b0 = bx * plan.rows_per_block
        b1 = min(b0 + plan.rows_per_block, plan.rows)
        per_slot = [[] for _ in range(slots)]
        if plan.stage_rows:
            for r0 in range(b0, b1, plan.stage_rows):
                rows = min(plan.stage_rows, b1 - r0)
                for slot in range(slots):
                    per_slot[slot] += [r0 + j for j in range(slot, rows, slots)]
        else:
            for slot in range(slots):
                per_slot[slot] = list(range(b0 + slot, b1, slots))
        out.append(per_slot)
    m = max(1, max(len(r) for per_slot in out for r in per_slot))
    rows = np.full((plan.blocks, slots, m), -1, np.int64)
    for bx, per_slot in enumerate(out):
        for slot, r in enumerate(per_slot):
            rows[bx, slot, :len(r)] = r
    return rows


def _fold_slots(red: np.ndarray, block: int) -> np.ndarray:
    """red (slots, 2 L) summed over its slots in fp32 as the kernel sums
    them: segs segments of consecutive slots, each in order from 0, then
    the segments in order from 0 (segs = block threads // 2 L, at least 1,
    at most slots)."""
    slots, cols = red.shape
    segs = max(1, min(block // cols, slots))
    per = -(-slots // segs)
    seg = np.zeros((segs, cols), F32)
    for sg in range(segs):
        for k in range(sg * per, min(slots, (sg + 1) * per)):
            seg[sg] = (seg[sg] + red[k]).astype(F32)
    if segs == 1:
        return seg[0]
    out = np.zeros(cols, F32)
    for sg in range(segs):
        out = (out + seg[sg]).astype(F32)
    return out


def _terms(x, dy, r, mean, rstd, gamma, beta, act):
    """fp32 (x - mean, dz) in memory order (N, S * C), rounded as the
    kernel rounds them (the plain version's elementwise ops)."""
    xm, _, dz, _ = gn.backward_terms_plain(x, dy, mean, rstd, gamma, beta, 1, r, act)
    flat = lambda t: t.permute(0, 2, 3, 4, 1).reshape(t.shape[0], -1).float().numpy()
    return flat(xm), flat(dz)


def emulate_reduce(plan: gn.ReducePlan, xm: np.ndarray, dz: np.ndarray, rstd: np.ndarray,
                   gamma: np.ndarray, groups: int, count: int, fold: bool = True):
    """(4 or 2, N, C) fp32 of the kernel's fixed-order sums from the
    elementwise terms (N, S * C); asserts the walk's coverage."""
    n, c = rstd.shape
    v, row = plan.vec, plan.row
    slots = plan.threads // plan.chunk
    lanes = plan.chunk * v
    rows = _thread_rows(plan)                                   # (bx, slot, m)
    z, cl, k = np.meshgrid(np.arange(plan.chunks), np.arange(plan.chunk), np.arange(v),
                           indexing="ij")
    cv = z * plan.chunk + cl                                    # (z, cl, V)
    live_v = cv < row // v
    # element of (bx, slot, m, z, cl, lane) within its sample, -1 if none
    el = rows[:, :, :, None, None, None] * row + (cv * v + k)[None, None, None]
    live = (rows >= 0)[:, :, :, None, None, None] & live_v[None, None, None]
    el = np.where(live, el, -1)
    hits = np.bincount(el[el >= 0].ravel(), minlength=plan.rows * row)
    assert (hits == 1).all(), "every element of a sample read once"
    lane_ch = (z * lanes + cl * v + k) % c                      # (z, cl, V)
    assert (np.broadcast_to(lane_ch, el.shape)[live] == el[live] % c).all()
    nb = plan.blocks
    out = np.zeros((4 if fold else 2, n, c), F32)
    for s in range(n):
        take = lambda a: np.where(live, a[s][np.maximum(el, 0)], F32(0))
        d, xmv = take(dz), take(xm)
        sa = np.zeros(d.shape[:2] + d.shape[3:], F32)           # (bx, slot, z, cl, V)
        sb = np.zeros_like(sa)
        for m in range(d.shape[2]):                             # each thread's rows in order
            sa = (sa + d[:, :, m]).astype(F32)
            sb = (sb.astype(np.float64) + d[:, :, m].astype(np.float64)
                  * xmv[:, :, m].astype(np.float64)).astype(F32)   # __fmaf_rn
        rs = np.where(live_v, rstd[s][lane_ch], F32(0))
        sb = (sb * rs).astype(F32)
        part = np.zeros((nb, 2, c), F32)
        block = plan.threads + (32 if plan.stage_rows else 0)
        for bx in range(nb):
            for zz in range(plan.chunks):
                cols = np.concatenate([t[bx][:, zz].reshape(slots, lanes) for t in (sa, sb)], 1)
                red = _fold_slots(cols, block).reshape(2, lanes)
                ch0 = zz * lanes % c
                cb = min(lanes, c - ch0)
                for q, colsum in enumerate(red):
                    # channel j adds lane columns j, j + C, ... in order
                    acc = np.zeros(cb, F32)
                    for lc0 in range(0, lanes, c):
                        acc = (acc + colsum[lc0:lc0 + cb]).astype(F32)
                    part[bx, q, ch0:ch0 + cb] = acc
        if nb * plan.chunks == 1:
            tot = part[0]
        else:
            segs = max(1, min(block // (2 * c), nb))
            per = -(-nb // segs)
            seg = np.zeros((segs, 2, c), F32)
            for sg in range(segs):
                for bx in range(sg * per, min(nb, (sg + 1) * per)):
                    seg[sg] = (seg[sg] + part[bx]).astype(F32)
            tot = np.zeros((2, c), F32)
            for sg in range(segs):
                tot = (tot + seg[sg]).astype(F32)
        out[0, s], out[1, s] = tot
        if not fold:
            continue
        cg = c // groups
        for g in range(groups):
            acc = np.zeros((2, 32), F32)
            for j0 in range(0, cg, 32):
                ch = g * cg + j0 + np.arange(32)
                ok = j0 + np.arange(32) < cg
                chc = np.minimum(ch, c - 1)
                add = np.where(ok, (gamma[chc] * tot[:, chc]).astype(F32), F32(0))
                acc = (acc + add).astype(F32)
            for o in (16, 8, 4, 2, 1):
                acc = (acc + acc[:, np.arange(32) ^ o]).astype(F32)
            ga, gb = acc[:, 0]
            r = rstd[s, g * cg:(g + 1) * cg]
            out[2, s, g * cg:(g + 1) * cg] = -(((r * r).astype(F32) * gb).astype(F32)
                                               / F32(count)).astype(F32)
            out[3, s, g * cg:(g + 1) * cg] = -((r * ga).astype(F32) / F32(count)).astype(F32)
    return out


def _activation(shape, dtype, offset, seed):
    """(N, C, D, H, W) channels_last_3d, ``offset`` elements into its storage."""
    rng = np.random.default_rng(seed)
    n, c, *sp = shape
    count = n * c * int(np.prod(sp))
    flat = torch.from_numpy(rng.normal(0.3, 1.0, offset + count).astype(F32)).to(dtype)
    x = flat[offset:].view(n, *sp, c).permute(0, 4, 1, 2, 3)
    assert x.is_contiguous(memory_format=CL3D) and x.storage_offset() == offset
    return x


def _operands(c, dtype, offset, residual, spatial, seed):
    shape = (2, c, *spatial)
    x = _activation(shape, dtype, offset, seed)
    dy = _activation(shape, dtype, offset, seed + 1) - 0.3
    r = _activation(shape, dtype, offset, seed + 2) - 0.3 if residual else None
    g = np.random.default_rng(seed + 3)
    w = torch.from_numpy(g.random(c).astype(F32) + 0.5)
    w[0] = 0.0   # rstd, not mul, scales coeff_b there
    b = torch.from_numpy(g.random(c).astype(F32) - 0.5)
    return x, dy, r, w, b


def _check_coefficients(got, x, dy, r, stats, w, b, groups, act):
    """The emulated (4, N, C) against backward_terms_plain's fp32 and its
    sums in float64, within 1e-5 x max |ref| per output."""
    xm, _, dz, coef = gn.backward_terms_plain(x, dy, stats.mean, stats.rstd, w, b, groups,
                                              r, act)
    a64 = dz.double().sum(dim=(2, 3, 4))
    b64 = (dz.double() * xm.double()).sum(dim=(2, 3, 4)) * stats.rstd.double()
    n, c = stats.mean.shape
    count = (x.numel() // (n * c)) * (c // groups)
    cb64, cc64 = gn.backward_coefficients(a64, b64, stats.rstd.double(), w, groups, count)
    for ref in (coef.numpy(), torch.stack((a64, b64, cb64, cc64)).numpy()):
        for q in range(len(got)):
            tol = 1e-5 * np.abs(ref[q]).max()
            assert np.abs(got[q] - ref[q]).max() <= tol, (q, np.abs(got[q] - ref[q]).max(), tol)


# (C, dtype, storage offset, spatial): the model's channel counts and the
# gcr input's C = 1 on every route, aligned and offset; C < V at an S the
# packed route refuses
_CASES = [(c, dtype, offset, SPATIAL)
          for c in (1, 8, 32, 512, 768)
          for dtype in (torch.bfloat16, torch.float32)
          for offset in (0, 1)]
_CASES += [(1, torch.bfloat16, 0, ODD_SPATIAL), (2, torch.float32, 0, ODD_SPATIAL)]


def _case_id(case):
    c, dtype, offset, spatial = case
    return (f"c{c}-{'bf16' if dtype == torch.bfloat16 else 'fp32'}-"
            f"{'offset' if offset else 'aligned'}{'-odd' if spatial == ODD_SPATIAL else ''}")


def _plans(n, s, c, esize, aligned, operands):
    """The planner's plan on a 132-SM card and a 2-SM card, then each on
    the walk and, where it takes the shape, the ring (its stages cut to
    256 bytes of an operand: several a block), and a split of one unrolled
    step of rows a thread (many blocks a sample)."""
    out = {}
    for sms in (132, 2):
        base = gn.plan_bwd_reduce(n, s, c, esize, aligned, sms, operands)
        assert base.route == _expected_route(c, esize, aligned, s)
        slots = base.threads // base.chunk
        for ring in (False, True):
            try:
                plan = gn.plan_bwd_reduce(n, s, c, esize, aligned, sms, operands, ring=ring)
                if ring:
                    plan = plan._replace(stage_rows=max(1, 256 // (plan.row * esize)))
            except ValueError:
                assert base.route == "scalar" or base.chunks > 1 or base.threads % 32
                continue
            out[f"sms{sms}-ring{int(ring)}"] = plan
            step = slots * gn._REDUCE_ROWS
            out[f"sms{sms}-ring{int(ring)}-split"] = plan._replace(
                rows_per_block=step, blocks=-(-plan.rows // step))
    return out


@pytest.mark.parametrize("case", _CASES, ids=_case_id)
def test_emulated_reduce_equals_plain_within_rtol(case):
    c, dtype, offset, spatial = case
    residual = (c + offset) % 2 == 1
    act = _ACTS[(c + offset + int(dtype == torch.float32)) % len(_ACTS)]
    groups = 8 if c % 8 == 0 else 1
    x, dy, r, w, b = _operands(c, dtype, offset, residual, spatial, seed=c + offset)
    stats = gn.group_norm_moments_plain(x, groups, w, 1e-5)
    n, s = x.shape[0], x.numel() // (x.shape[0] * c)
    xm, dz = _terms(x, dy, r, stats.mean, stats.rstd, w, b, act)
    plans = _plans(n, s, c, x.element_size(), offset == 0, 3 if residual else 2)
    assert plans
    for tag, plan in plans.items():
        for fold in (True, False):
            got = emulate_reduce(plan, xm, dz, stats.rstd.numpy(), w.numpy(), groups,
                                 s * (c // groups), fold)
            _check_coefficients(got, x, dy, r, stats, w, b, groups, act)


@pytest.mark.parametrize("act,residual", [("e", True), ("e", False), ("r", True), ("l", False),
                                          (None, True)])
def test_emulated_coefficients_give_jax_vjp_gradients(act, residual):
    """dx, dγ, dβ (and d(residual)) from the emulated coefficients of a
    split ring plan (many blocks a sample) against ``jax.vjp`` of flax
    GroupNorm (+ residual) (+ nonlinearity), fp32, 1e-5 x max |ref|."""
    c, groups, spatial = 32, 8, (6, 8, 10)
    x, dy, r, w, b = _operands(c, torch.float32, 0, residual, spatial, seed=90)
    stats = gn.group_norm_moments_plain(x, groups, w, 1e-5)
    n, s = 2, int(np.prod(spatial))
    plan = _plans(n, s, c, 4, True, 3 if residual else 2)["sms2-ring1-split"]
    assert plan.stage_rows and plan.blocks > 1
    xm_f, dz_f = _terms(x, dy, r, stats.mean, stats.rstd, w, b, act)
    coef = emulate_reduce(plan, xm_f, dz_f, stats.rstd.numpy(), w.numpy(), groups,
                          s * (c // groups))
    xm, mul, dz, _ = gn.backward_terms_plain(x, dy, stats.mean, stats.rstd, w, b, groups, r,
                                             act)
    dx, dr = gn._backward_apply_plain(x, xm, mul, dz, torch.from_numpy(coef), r)
    port = [dx, torch.from_numpy(coef[1].sum(0)), torch.from_numpy(coef[0].sum(0))]
    port = [t.permute(0, 2, 3, 4, 1).numpy() if t.dim() == 5 else t.numpy() for t in port]
    if residual:
        port.append(dr.permute(0, 2, 3, 4, 1).numpy())

    nhwc = lambda t: jnp.asarray(t.permute(0, 2, 3, 4, 1).numpy())

    def f(xj, scale, bias, rj):
        y = nn.GroupNorm(num_groups=groups, epsilon=1e-5, dtype=jnp.float32).apply(
            {"params": {"scale": scale, "bias": bias}}, xj)
        return _FLAX_ACT[act](y + rj if residual else y)

    rj = nhwc(r) if residual else jnp.zeros(x.permute(0, 2, 3, 4, 1).shape, jnp.float32)
    _, vjp = jax.vjp(f, nhwc(x), jnp.asarray(w.numpy()), jnp.asarray(b.numpy()), rj)
    ref = [np.asarray(g, F32) for g in vjp(nhwc(dy))]
    for name, got, want in zip(("dx", "dgamma", "dbeta", "dresidual"), port, ref):
        tol = 1e-5 * np.abs(want).max()
        assert np.abs(got - want).max() <= tol, (name, np.abs(got - want).max(), tol)


# (N, S, C, esize, aligned, SMs, operands, route, chunks): the batch-32
# step's level 0 and level 4, the f_maps-64 level 4, the gcr input, a
# slab's level 4 at batch 4, a misaligned base, S * C not a multiple of V
_PLAN_CASES = [
    (32, 96**3, 32, 2, True, 132, 3, "vector", 1),
    (32, 6**3, 512, 2, True, 132, 2, "vector", 2),
    (4, 6**3, 1024, 2, True, 132, 3, "vector", 4),
    (8, 96**3, 1, 2, True, 132, 2, "packed", 1),
    (8, 96**3, 1, 4, True, 132, 2, "packed", 1),
    (4, 4 * 8 * 8, 512, 4, True, 132, 2, "vector", 4),
    (8, 96**3, 1, 2, False, 132, 2, "scalar", 1),
    (2, 105, 4, 2, True, 132, 2, "scalar", 1),
    (2, 30, 768, 2, False, 2, 2, "scalar", 24),
]


@pytest.mark.parametrize("case", _PLAN_CASES, ids=lambda c: "-".join(map(str, c[:7])))
def test_plan_bwd_reduce_routes_chunks_and_grid(case):
    n, s, c, esize, aligned, sms, ops, route, chunks = case
    plan = gn.plan_bwd_reduce(n, s, c, esize, aligned, sms, ops)
    assert plan.route == route == _expected_route(c, esize, aligned, s)
    assert plan.chunks == chunks
    vecs = plan.row // plan.vec
    slots = plan.threads // plan.chunk
    assert plan.chunk <= gn._REDUCE_CHUNK and plan.chunk * plan.chunks >= vecs
    assert (plan.chunk - 1) * plan.chunks < vecs      # chunks as even as they go
    assert plan.threads % plan.chunk == 0 and plan.threads <= gn._REDUCE_THREADS
    # every row in one block, no block empty; whole unrolled steps a thread
    assert plan.blocks * plan.rows_per_block >= plan.rows > (plan.blocks - 1) * plan.rows_per_block
    assert plan.rows_per_block % (slots * gn._REDUCE_ROWS) == 0
    per_sm = gn._WALK_BLOCKS_PER_SM
    if plan.stage_rows:
        assert plan.route != "scalar" and plan.chunks == 1 and plan.threads % 32 == 0
        assert gn._RING_STAGES * ops * plan.stage_rows * plan.row * esize <= gn._RING_BYTES
        per_sm = gn._RING_BLOCKS_PER_SM
    # one wave where the samples allow it, and then at least half a wave
    # unless a block is down to one step of rows a thread
    assert plan.blocks * plan.chunks * n <= max(per_sm * sms, n * plan.chunks)
    if plan.rows_per_block > slots * gn._REDUCE_ROWS:
        assert plan.blocks * plan.chunks * n > per_sm * sms / 2


def test_reduce_plan_refuses_the_ring_where_rows_are_not_one_span():
    with pytest.raises(ValueError, match="ring"):
        gn.plan_bwd_reduce(32, 6**3, 512, 2, True, 132, 2, ring=True)
    with pytest.raises(ValueError, match="ring"):
        gn.plan_bwd_reduce(2, 105, 4, 2, True, 132, 2, ring=True)


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("act", _ACTS)
def test_c1_fp32_dgamma_dbeta_of_both_paths_against_float64(act, residual):
    """The card case ``c1-packed-many-blocks-fp32`` on the CPU, its seeded
    inputs alike: (8, 1, 32, 32, 32) fp32 in one group with gamma 0, so dγ
    is one sum over 8 x 32768 terms that cancel (to -1.227 from a sum of
    magnitudes of 1.2e5 with ELU and the residual).  The plain path's dγ,
    dβ (fp32 on this CPU) and the emulated kernel's on its 132-SM plan
    each lie within 1e-4 x |float64 sum| of the float64 sum of their own
    fp32 terms (``float64_sums``)."""
    shape, dtype, offset, groups = _BWD_CASES["c1-packed-many-blocks-fp32"]
    cpu = torch.device("cpu")
    x = _card_activation(shape, dtype, cpu, 12, offset)
    dy = _card_activation(shape, dtype, cpu, 13, offset) - 0.5
    r = _card_activation(shape, dtype, cpu, 14, offset) - 0.5 if residual else None
    g = torch.Generator().manual_seed(15)
    w = torch.rand(1, generator=g) + 0.5
    w[0] = 0.0
    b = torch.rand(1, generator=g) - 0.5
    stats = gn.group_norm_moments_plain(x, groups, w, 1e-5)
    f64 = float64_sums(x, dy, stats, w, b, groups, r, act)
    plain = gn.group_norm_backward_plain(x, dy, stats.mean, stats.rstd, w, b, groups, r, act)
    n, s = shape[0], x.numel() // shape[0]
    plan = gn.plan_bwd_reduce(n, s, 1, 4, True, 132, 3 if residual else 2, act=act)
    assert plan.route == "packed" and plan.blocks > 1
    xm, dz = _terms(x, dy, r, stats.mean, stats.rstd, w, b, act)
    coef = torch.from_numpy(emulate_reduce(plan, xm, dz, stats.rstd.numpy(), w.numpy(),
                                           groups, s))
    for path, got, ref in (("plain", plain.dweight, f64["dgamma_plain"]),
                           ("plain", plain.dbias, f64["dbeta"]),
                           ("kernel", coef[1].sum(0), f64["dgamma_kernel"]),
                           ("kernel", coef[0].sum(0), f64["dbeta"])):
        err = float((got.double() - ref).abs().max())
        assert err <= 1e-4 * float(ref.abs().max()), (path, err, float(ref[0]))
