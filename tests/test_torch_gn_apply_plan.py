"""K1's two apply kernels on the CPU: ``plan_apply`` and a numpy emulation
of the walk of ``gn_apply_kernel`` and ``gn_bwd_apply_kernel``
(``tpu_mednet_torch/csrc/groupnorm.cu``) on the vector, packed and scalar
routes.

The kernels cannot run here, so the emulation follows their walk: block
(bx, n, z) of ``threads`` threads; thread t owns channel vector
z * chunk + t % chunk in row slot t / chunk and takes rows slot,
slot + slots, ... of the block's ``rows_per_block``; lane i of its vector
keeps channel (vector * V + i) % C.  Each case asserts that every element
is written once and reads the coefficients of its own (n, c), and that the
kernels' arithmetic in that walk, in their fp32 order, equals the plain
versions bit for bit.
"""

import numpy as np
import pytest
import torch

from tpu_mednet_torch.ops import groupnorm as gn

CL3D = torch.channels_last_3d
SMS = 132
SPATIAL = (4, 5, 6)        # S = 120: S * C a multiple of 8 at every C
ODD_SPATIAL = (3, 5, 7)    # S = 105: the packed route refuses it
_ACTS = (None, "e", "r", "l")


def _walk(plan: gn.ApplyPlan, n: int, c: int):
    """(element offsets (K, V), sample (K,), lane channels (K, V)) of every
    vector the grid's threads take, for N samples of ``plan.rows`` rows."""
    slots = plan.threads // plan.chunk
    vecs = plan.row // plan.vec
    bx, nn, z, t = np.meshgrid(np.arange(plan.blocks), np.arange(n), np.arange(plan.chunks),
                               np.arange(plan.threads), indexing="ij")
    slot, cv = t // plan.chunk, z * plan.chunk + t % plan.chunk
    b0 = bx * plan.rows_per_block
    r1 = np.minimum(b0 + plan.rows_per_block, plan.rows)
    r = (b0 + slot)[..., None] + np.arange(-(-plan.rows_per_block // slots)) * slots
    live = (cv < vecs)[..., None] & (r < r1[..., None])
    first = ((nn[..., None] * plan.rows + r) * plan.row + cv[..., None] * plan.vec)[live]
    lanes = np.arange(plan.vec)
    cv = np.broadcast_to(cv[..., None], live.shape)[live]
    sample = np.broadcast_to(nn[..., None], live.shape)[live]
    return first[:, None] + lanes, sample, (cv[:, None] * plan.vec + lanes) % c


def _expected_route(c, esize, aligned, s):
    wide = 16 // esize
    if aligned and c % wide == 0:
        return "vector"
    if aligned and c < wide and wide % c == 0 and s * c % wide == 0:
        return "packed"
    return "scalar"


def _check_walk(plan, n, s, c):
    """Every element once, each with its own (n, c)."""
    offsets, sample, chans = _walk(plan, n, c)
    hits = np.bincount(offsets.ravel(), minlength=n * s * c)
    assert hits.shape == (n * s * c,) and (hits == 1).all()
    assert (chans == offsets % c).all()
    assert (sample[:, None] == offsets // (s * c)).all()
    return offsets, sample, chans


def _inputs(c, dtype, offset, spatial, seed, n=2):
    """(N, C, D, H, W) channels_last_3d, ``offset`` elements into its storage."""
    rng = np.random.default_rng(seed)
    count = n * c * int(np.prod(spatial))
    flat = torch.from_numpy(rng.standard_normal(offset + count).astype(np.float32) + 0.5)
    x = flat.to(dtype)[offset:].view(n, *spatial, c).permute(0, 4, 1, 2, 3)
    assert x.is_contiguous(memory_format=CL3D) and x.storage_offset() == offset
    return x


def _flat(t: torch.Tensor) -> np.ndarray:
    """fp32 values of a channels_last_3d tensor in memory order."""
    return t.permute(0, 2, 3, 4, 1).reshape(-1).float().numpy()


def _bits(t: torch.Tensor) -> np.ndarray:
    raw = t.permute(0, 2, 3, 4, 1).reshape(-1).contiguous()
    return raw.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32).numpy()


def _rounded(values: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """fp32 values in memory order, rounded once to ``like``'s dtype, as a
    channels_last_3d tensor of its shape."""
    n, c, *sp = like.shape
    out = torch.from_numpy(values).view(n, *sp, c).permute(0, 4, 1, 2, 3)
    return out.to(like.dtype)


def _act(values: np.ndarray, act, like) -> np.ndarray:
    """The nonlinearity on fp32 values in memory order, shaped as the plain
    version's tensor so it runs the same elementwise loop."""
    n, c, *sp = like.shape
    z = torch.from_numpy(values).view(n, *sp, c).permute(0, 4, 1, 2, 3)
    return gn.activation_plain(z, act).permute(0, 2, 3, 4, 1).reshape(-1).numpy()


def _act_grad(values: np.ndarray, act, like) -> np.ndarray:
    n, c, *sp = like.shape
    z = torch.from_numpy(values).view(n, *sp, c).permute(0, 4, 1, 2, 3)
    return gn.activation_grad_plain(z, act).permute(0, 2, 3, 4, 1).reshape(-1).numpy()


# (C, dtype, storage offset, residual, spatial): every route at the model's
# channel counts, aligned and offset; then C < V at an S the packed route refuses
_CASES = [(c, dtype, offset, residual, SPATIAL)
          for c in (1, 2, 4, 8, 12, 32, 192, 768)
          for dtype in (torch.bfloat16, torch.float32)
          for offset in (0, 1)
          for residual in (False, True)]
_CASES += [(c, dtype, 0, True, ODD_SPATIAL)
           for c, dtype in ((1, torch.bfloat16), (2, torch.bfloat16), (4, torch.bfloat16),
                            (2, torch.float32))]


def _case_id(case):
    c, dtype, offset, residual, spatial = case
    return (f"c{c}-{'bf16' if dtype == torch.bfloat16 else 'fp32'}-"
            f"{'offset' if offset else 'aligned'}{'-residual' if residual else ''}"
            f"{'-odd' if spatial == ODD_SPATIAL else ''}")


def _setup(case):
    c, dtype, offset, residual, spatial = case
    act = _ACTS[(c + offset) % len(_ACTS)]
    x = _inputs(c, dtype, offset, spatial, seed=c)
    r = _inputs(c, dtype, offset, spatial, seed=c + 1000) - 0.5 if residual else None
    n, s = x.shape[0], x.numel() // (x.shape[0] * c)
    esize = x.element_size()
    # torch's CPU storage is 16-byte aligned: an offset of one element is not
    aligned = offset == 0
    plan = gn.plan_apply(n, s, c, esize, aligned, SMS)
    assert plan.route == _expected_route(c, esize, aligned, s)
    assert plan.threads % plan.chunk == 0 and plan.threads <= gn._APPLY_MAX_THREADS
    assert plan.vec == (16 // esize if plan.route != "scalar" else 1)
    return x, r, act, n, s, c, plan


@pytest.mark.parametrize("case", _CASES, ids=_case_id)
def test_emulated_apply_walk_equals_plain_bitwise(case):
    x, r, act, n, s, c, plan = _setup(case)
    g = np.random.default_rng(7)
    w = torch.from_numpy(g.random(c).astype(np.float32) + 0.5)
    b = torch.from_numpy(g.random(c).astype(np.float32) - 0.5)
    stats = gn.group_norm_moments_plain(x, min(c, 8) if c % 8 == 0 else 1, w, 1e-5)
    offsets, sample, chans = _check_walk(plan, n, s, c)
    mean, mul, beta = stats.mean.numpy(), stats.mul.numpy(), b.numpy()
    xf = _flat(x)
    # gn_apply_kernel's arithmetic per lane, each fp32 operation rounded
    t = (xf[offsets] - mean[sample[:, None], chans]) * mul[sample[:, None], chans]
    t = t + beta[chans]
    if r is not None:
        t = t + _flat(r)[offsets]
    z = np.empty(n * s * c, np.float32)
    z[offsets] = t
    got = _rounded(_act(z, act, x), x)
    ref = gn.group_norm_apply_plain(x, stats.mean, stats.mul, b, residual=r, act=act)
    assert np.array_equal(_bits(got), _bits(ref))


@pytest.mark.parametrize("case", _CASES, ids=_case_id)
def test_emulated_backward_apply_walk_equals_plain_bitwise(case):
    x, r, act, n, s, c, plan = _setup(case)
    groups = 8 if c % 8 == 0 else 1
    g = np.random.default_rng(8)
    w = torch.from_numpy(g.random(c).astype(np.float32) + 0.5)
    w[0] = 0.0  # mul = rstd * gamma is 0 there; rstd still scales coeff_b
    b = torch.from_numpy(g.random(c).astype(np.float32) - 0.5)
    dy = _inputs(c, x.dtype, 0, tuple(x.shape[2:]), seed=c + 2000) - 0.5
    stats = gn.group_norm_moments_plain(x, groups, w, 1e-5)
    _, _, _, coef = gn.backward_terms_plain(x, dy, stats.mean, stats.rstd, w, b, groups, r,
                                            act)
    offsets, sample, chans = _check_walk(plan, n, s, c)
    at = (sample[:, None], chans)
    mean, rstd, gamma, beta = stats.mean.numpy(), stats.rstd.numpy(), w.numpy(), b.numpy()
    coeff_b, coeff_c = coef[2].numpy(), coef[3].numpy()
    xf, dyf = _flat(x), _flat(dy)
    # gn_bwd_apply_kernel's arithmetic per lane: mul taken once per thread
    ml = rstd[at] * gamma[chans]
    xm = xf[offsets] - mean[at]
    t = xm * ml + beta[chans]
    if r is not None:
        t = t + _flat(r)[offsets]
    z = np.empty(n * s * c, np.float32)
    z[offsets] = t
    dz = dyf[offsets] * _act_grad(z, act, x)[offsets]
    dx = np.empty(n * s * c, np.float32)
    dx[offsets] = (ml * dz + coeff_b[at] * xm) + coeff_c[at]
    dr = np.empty(n * s * c, np.float32)
    dr[offsets] = dz
    ref = gn.group_norm_backward_plain(x, dy, stats.mean, stats.rstd, w, b, groups, r, act)
    assert np.array_equal(_bits(_rounded(dx, x)), _bits(ref.dx))
    if r is not None:
        assert np.array_equal(_bits(_rounded(dr, x)), _bits(ref.dresidual))


# (N, S, C, esize, aligned, SMs, route): the UNet3D shapes on a 132-SM card,
# one sample of many rows on a small card (many rows a thread), S * C not a
# multiple of V, rows wider than one block of threads (chunks across a row)
_PLAN_CASES = [
    (8, 96**3, 192, 2, True, 132, "vector"),
    (8, 48**3, 384, 2, True, 132, "vector"),
    (8, 24**3, 768, 2, True, 132, "vector"),
    (8, 96**3, 1, 2, True, 132, "packed"),
    (8, 96**3, 1, 4, True, 132, "packed"),
    (1, 4096, 2, 2, True, 1, "packed"),
    (1, 4096, 32, 4, True, 1, "vector"),
    (2, 105, 4, 2, True, 132, "scalar"),
    (2, 105, 2, 4, True, 132, "scalar"),
    (2, 30, 1200, 2, False, 2, "scalar"),
    (1, 12, 8200, 2, True, 2, "vector"),
]


@pytest.mark.parametrize("case", _PLAN_CASES, ids=lambda c: "-".join(map(str, c[:6])))
def test_plan_apply_routes_and_covers_every_element_once(case):
    n, s, c, esize, aligned, sms, route = case
    plan = gn.plan_apply(n, s, c, esize, aligned, sms)
    assert plan.route == route == _expected_route(c, esize, aligned, s)
    vecs = plan.row // plan.vec
    slots = plan.threads // plan.chunk
    assert plan.threads % plan.chunk == 0 and plan.threads <= gn._APPLY_MAX_THREADS
    assert plan.chunks == -(-vecs // plan.chunk) and plan.chunk <= vecs
    # every row in one block, no block empty; a thread takes whole unrolled
    # steps of rows, at most _APPLY_MAX_ROWS
    assert plan.blocks * plan.rows_per_block >= plan.rows > (plan.blocks - 1) * plan.rows_per_block
    assert plan.rows_per_block % (slots * gn._APPLY_ROWS) == 0
    assert plan.rows_per_block <= slots * gn._APPLY_MAX_ROWS
    if plan.rows_per_block > slots * gn._APPLY_ROWS:   # then the grid is not starved
        assert plan.blocks * plan.chunks * n > gn._APPLY_BLOCKS_PER_SM * sms / 2
    if n * s * c <= 2**21:
        _check_walk(plan, n, s, c)


def test_plan_apply_fills_whole_warps_at_the_concatenations():
    """192, 384 and 768 bf16 channels: 24, 48 and 96 vectors a row, blocks of
    whole row slots and whole warps (8 x 24, 4 x 48, 2 x 96)."""
    for c, slots in ((192, 8), (384, 4), (768, 2)):
        plan = gn.plan_apply(8, 24**3, c, 2, True, SMS)
        assert (plan.chunk, plan.threads) == (c // 8, c // 8 * slots)
        assert plan.threads % 32 == 0
