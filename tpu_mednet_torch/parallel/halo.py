"""Spatial partitioning: rows exchanged between the X slabs of a volume.

Counterpart of ``tpu_mednet/parallel/halo.py``.  A volume's X axis is
split over the ranks of a data row (the mesh's ``space`` axis,
``parallel/mesh.py``); each 3^3 convolution needs one voxel of its
neighbours' rows per side, so ranks send boundary rows to each other
before the local computation.  Where the JAX package lets ``ppermute``
move them inside ``shard_map`` (and GSPMD insert them under ``jit``), the
port sends them point to point: NCCL's ``batch_isend_irecv`` for CUDA
tensors on an NCCL group; on a gloo group, whose ``send``/``recv`` take CPU
tensors only, CUDA rows are staged through pinned host buffers.  Every
send and receive of an exchange is posted before any is waited for, so a
ring cannot deadlock.  While a profiler records, each exchange is a span,
``sp.halo_exchange`` (``utils/tracing.py``).

- ``halo_exchange``: a slab padded with ``halo`` rows of its neighbours
  on each side (zeros beyond the volume's two ends), differentiable: the
  backward sends the halo rows' gradients back to their owners, which add
  them into their boundary rows;
- ``crop_halo``;
- ``spatially_sharded_apply``: a patchwise function run on every slab
  with a halo exchanged first and cropped after, JAX's padded-volume
  contract;
- ``mirror_rows``: this slab's rows of the volume mirrored along X (a
  mirror TTA of the split axis);
- ``SpaceAxis``: what a model's layers need to run on slabs (the mesh and
  the current ``slab_plan``; ``models/blocks.py``'s ``space_axis``).

Slabs may differ in length (``slab_plan`` keeps pooling windows whole);
``lengths`` gives every slab's rows along the split dim, and a halo may
reach past the next rank's slab, rows then coming from further ranks.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple, Union

import torch

from tpu_mednet_torch.parallel.mesh import DataMesh, SlabPlan
from tpu_mednet_torch.utils import tracing

Halo = Union[int, Tuple[int, int]]


def _offsets(lengths: Sequence[int]) -> List[int]:
    out = [0]
    for n in lengths:
        out.append(out[-1] + int(n))
    return out


def _transfers(lengths: Sequence[int], wants: Sequence[Tuple[int, int]]):
    """Every (src, dst, src row, dst row, rows) that gives space index dst
    its wanted global rows ``wants[dst]`` from the slab that holds them
    (src == dst for a slab's own rows), in one order every rank computes."""
    off = _offsets(lengths)
    out = []
    for dst, (start, stop) in enumerate(wants):
        for src in range(len(lengths)):
            a, b = max(start, off[src]), min(stop, off[src + 1])
            if a < b:
                out.append((src, dst, a - off[src], a - start, b - a))
    return out


def _format(x: torch.Tensor):
    """The memory format a 5-D activation keeps through an exchange."""
    return torch.channels_last_3d if x.dim() == 5 and x.is_contiguous(
        memory_format=torch.channels_last_3d) else torch.contiguous_format


def _buffer(shape, dtype, device, fmt, pin=False) -> torch.Tensor:
    if len(shape) != 5:
        fmt = torch.contiguous_format
    return torch.empty(shape, dtype=dtype, device=device, pin_memory=pin, memory_format=fmt)


def _wire(t: torch.Tensor) -> torch.Tensor:
    """How a message lays ``t`` out: a 5-D (N, C, X, Y, Z) tensor as
    (N, X, Y, Z, C), a view without a copy of a channels-last one."""
    return t.permute(0, 2, 3, 4, 1) if t.dim() == 5 else t


def _post(mesh: DataMesh, sends, recvs) -> None:
    """Send ``(peer space index, tag, tensor)`` and receive into
    ``(peer, tag, tensor)``: every operation posted, then all waited for.
    Messages are contiguous in ``_wire``'s layout on both sides; on gloo
    they pass through host memory (pinned for a CUDA tensor)."""
    import torch.distributed as dist

    gloo = dist.get_backend(mesh.group) == "gloo"
    staged = []  # (target view, buffer received into)
    posted_sends, posted_recvs = [], []
    for p, tag, t in sends:
        w = _wire(t)
        if gloo and w.device.type != "cpu":
            host = torch.empty(w.shape, dtype=w.dtype, pin_memory=True)
            host.copy_(w)  # waits for the rows on the device
            w = host
        posted_sends.append((p, tag, w.contiguous()))
    for p, tag, t in recvs:
        w = _wire(t)
        on = torch.device("cpu") if gloo else w.device
        if w.device == on and w.is_contiguous():
            buf = w
        else:
            buf = torch.empty(w.shape, dtype=w.dtype, device=on,
                              pin_memory=gloo and w.device.type == "cuda")
            staged.append((w, buf))
        posted_recvs.append((p, tag, buf))
    if gloo:
        works = [dist.irecv(b, mesh.space_rank(p), tag=tag) for p, tag, b in posted_recvs]
        works += [dist.isend(b, mesh.space_rank(p), tag=tag) for p, tag, b in posted_sends]
    else:
        ops = [dist.P2POp(dist.irecv, b, mesh.space_rank(p), tag=tag)
               for p, tag, b in posted_recvs]
        ops += [dist.P2POp(dist.isend, b, mesh.space_rank(p), tag=tag)
                for p, tag, b in posted_sends]
        works = dist.batch_isend_irecv(ops)
    for w in works:
        w.wait()
    for w, buf in staged:
        w.copy_(buf, non_blocking=buf.is_pinned())


def _exchange(mesh: DataMesh, sends, recvs) -> None:
    """Post one forward or backward exchange that moves rows between ranks
    (traced as ``sp.halo_exchange``, its waits included)."""
    if sends or recvs:
        with tracing.span("sp.halo_exchange"):
            _post(mesh, sends, recvs)


def _gather(x: torch.Tensor, mesh: DataMesh, plan, dim: int) -> torch.Tensor:
    """This slab's wanted rows (zeros where the volume has none)."""
    lengths, wants = plan
    me = mesh.space_index
    start, stop = wants[me]
    width = stop - start
    shape = list(x.shape)
    shape[dim] = width
    out = _buffer(shape, x.dtype, x.device, _format(x))
    # rows outside the volume are zeros; every row inside comes from a slab
    before = min(max(0, -start), width)
    after = min(max(0, stop - max(start, sum(lengths))), width - before)
    if before:
        out.narrow(dim, 0, before).zero_()
    if after:
        out.narrow(dim, width - after, after).zero_()
    sends, recvs = [], []
    for tag, (src, dst, a, p, n) in enumerate(_transfers(lengths, wants)):
        if src == me and dst == me:
            out.narrow(dim, p, n).copy_(x.narrow(dim, a, n))
        elif src == me:
            sends.append((dst, tag, x.narrow(dim, a, n)))
        elif dst == me:
            recvs.append((src, tag, out.narrow(dim, p, n)))
    _exchange(mesh, sends, recvs)
    return out


def _scatter_add(g: torch.Tensor, mesh: DataMesh, plan, dim: int, shape) -> torch.Tensor:
    """The transpose of ``_gather``: each wanted row's gradient sent back to
    its owner and added into the owner's row."""
    lengths, wants = plan
    me = mesh.space_index
    fmt = _format(g)
    grad = _buffer(shape, g.dtype, g.device, fmt).zero_()
    sends, recvs, adds = [], [], []
    for tag, (src, dst, a, p, n) in enumerate(_transfers(lengths, wants)):
        if src == me and dst == me:
            grad.narrow(dim, a, n).add_(g.narrow(dim, p, n))
        elif dst == me:
            sends.append((src, tag, g.narrow(dim, p, n)))
        elif src == me:
            buf = _buffer([n if i == dim else s for i, s in enumerate(shape)], g.dtype,
                          g.device, fmt)
            recvs.append((dst, tag, buf))
            adds.append((a, n, buf))
    _exchange(mesh, sends, recvs)
    for a, n, buf in adds:
        grad.narrow(dim, a, n).add_(buf)
    return grad


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, plan, dim):
        ctx.mesh, ctx.plan, ctx.dim, ctx.shape = mesh, plan, dim, tuple(x.shape)
        ctx.fmt = _format(x)
        return _gather(x, mesh, plan, dim)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous(memory_format=ctx.fmt) if g.dim() == 5 else g.contiguous()
        return _scatter_add(g, ctx.mesh, ctx.plan, ctx.dim, ctx.shape), None, None, None


def gather_rows(x: torch.Tensor, mesh: DataMesh, lengths: Sequence[int],
                wants: Sequence[Tuple[int, int]], dim: int = 2) -> torch.Tensor:
    """Global rows ``wants[s]`` (start, stop) of the volume whose slab
    ``x`` is, for this rank's space index ``s``, with zeros outside the
    volume; ``lengths`` are every slab's rows along ``dim``.
    Differentiable."""
    if len(lengths) != mesh.n_space or len(wants) != mesh.n_space:
        raise ValueError(f"{len(lengths)} slab lengths and {len(wants)} ranges for a space "
                         f"axis of {mesh.n_space}")
    if x.shape[dim] != lengths[mesh.space_index]:
        raise ValueError(f"slab of {x.shape[dim]} rows, the plan says "
                         f"{lengths[mesh.space_index]}")
    plan = (tuple(int(n) for n in lengths), tuple((int(a), int(b)) for a, b in wants))
    return _GatherRows.apply(x, mesh, plan, dim)


def _pair(halo: Halo) -> Tuple[int, int]:
    lo, hi = (halo, halo) if isinstance(halo, int) else halo
    if lo < 0 or hi < 0:
        raise ValueError(f"halo must be >= 0, got {halo}")
    return int(lo), int(hi)


def halo_exchange(x: torch.Tensor, halo: Halo, mesh: DataMesh, dim: int = 2,
                  lengths: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Pad a slab with ``halo`` rows from its neighbours on each side
    (``(lo, hi)`` for two sizes): the left ``lo`` rows are the ones before
    the slab's first, the right ``hi`` the ones after its last, zeros
    beyond the volume's ends (zero-padded convolution at the borders).
    ``lengths`` defaults to every slab as long as this one, the JAX
    package's even shards.  Differentiable."""
    lo, hi = _pair(halo)
    if not mesh.spatial:
        if lo or hi:
            pad = [0] * (2 * (x.dim() - dim - 1)) + [lo, hi]
            return torch.nn.functional.pad(x, pad)
        return x
    if lengths is None:
        lengths = (x.shape[dim],) * mesh.n_space
    off = _offsets(lengths)
    wants = [(off[s] - lo, off[s + 1] + hi) for s in range(mesh.n_space)]
    return gather_rows(x, mesh, lengths, wants, dim)


def crop_halo(x: torch.Tensor, halo: Halo, dim: int = 2) -> torch.Tensor:
    lo, hi = _pair(halo)
    return x.narrow(dim, lo, x.shape[dim] - lo - hi)


def spatially_sharded_apply(fn: Callable[[torch.Tensor], torch.Tensor], mesh: DataMesh,
                            halo: int, dim: int = 2,
                            lengths: Optional[Sequence[int]] = None
                            ) -> Callable[[torch.Tensor], torch.Tensor]:
    """``fn`` (volume -> volume, shape-preserving along ``dim``) run on
    this rank's slab with a halo exchanged first and cropped after.

    Contract (``tpu_mednet/parallel/halo.py:85-89``): the slabs put
    together equal ``crop(fn(zero_pad(volume, halo)), halo)`` computed
    unsharded, exactly, provided ``halo`` covers fn's receptive-field
    reach, and fn is patchwise (a GroupNorm's statistics are the padded
    slab's own)."""

    def local(x: torch.Tensor) -> torch.Tensor:
        return crop_halo(fn(halo_exchange(x, halo, mesh, dim, lengths)), halo, dim)

    return local


def mirror_rows(x: torch.Tensor, mesh: DataMesh, lengths: Sequence[int],
                dim: int = 2) -> torch.Tensor:
    """This slab's rows of the volume flipped along ``dim``: global row
    ``i`` of the result is row ``E - 1 - i`` of the volume.  Differentiable."""
    if not mesh.spatial:
        return torch.flip(x, (dim,))
    off = _offsets(lengths)
    extent = off[-1]
    wants = [(extent - off[s + 1], extent - off[s]) for s in range(mesh.n_space)]
    return torch.flip(gather_rows(x, mesh, lengths, wants, dim), (dim,))


def gather_volume(x: torch.Tensor, mesh: DataMesh, lengths: Sequence[int],
                  dim: int = 2) -> torch.Tensor:
    """Every slab of the data row put together, on every rank of it."""
    if not mesh.spatial:
        return x
    return gather_rows(x, mesh, lengths, [(0, sum(lengths))] * mesh.n_space, dim)


class SpaceAxis:
    """The space axis as a model's layers see it: ``mesh`` and the slab
    plan of the level-0 X extent this forward runs on (``plan``, set by
    the step or the predictor before the forward).  A layer at a deeper
    level scales the plan by its own slab's length: every slab is a whole
    number of pooling windows, so level l's slabs are level 0's over 2^l."""

    def __init__(self, mesh: DataMesh, plan: Optional[SlabPlan] = None):
        if not mesh.spatial:
            raise ValueError("a SpaceAxis needs a mesh with more than one space rank")
        self.mesh = mesh
        self.plan = plan

    def lengths(self, local: int) -> Tuple[int, ...]:
        """Every slab's rows at the level where this rank's has ``local``."""
        if self.plan is None:
            raise RuntimeError("SpaceAxis.plan is not set: slab the input first")
        mine = self.plan.lengths[self.mesh.space_index]
        if not 0 < local <= mine or mine % local:
            raise ValueError(f"a slab of {local} rows is not a level of this rank's "
                             f"{mine}")
        return tuple(n * local // mine for n in self.plan.lengths)

    def extent(self, local: int) -> int:
        """The volume's X extent at the level where this rank's slab has
        ``local`` rows."""
        return sum(self.lengths(local))

    def exchange(self, x: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
        """``x`` (N, C, X, Y, Z) padded along X with ``lo``/``hi`` halo rows."""
        return halo_exchange(x, (lo, hi), self.mesh, 2, self.lengths(x.shape[2]))

    def reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the data row's ranks, in place."""
        return self.mesh.space_sum_(t)
