"""The (data, space) mesh: ranks, their devices and nodes, and the reductions over them.

Counterpart of ``tpu_mednet/parallel/mesh.py``.  The JAX package builds a
``jax.sharding.Mesh`` of ``n_data x n_space`` devices and lets GSPMD shard
one global batch over ``data`` (rows) and, with ``n_space`` above 1, the
patch X axis over ``space``, so every reduction of the train step is
global and every convolution gets its halo.  The port runs one process (a
*rank*) per device instead, rank ``d * n_space + s`` at data index ``d``
and space index ``s`` (JAX's ``reshape(n_data, n_space)`` order).  The
ranks of a data row hold that row's samples, each its own X slab
(``slab_plan``); it makes the reductions global by hand:
``DataMesh.all_sum`` all-reduces a sum over every rank inside autograd
before the loss divides by it, BatchNorm's statistics go through it,
``space_sum_`` adds GroupNorm's per-slab sums over the data row, and
``average_gradients`` averages the parameters' gradients after the
backward.  The halo exchange is ``parallel/halo.py``.  A *node* is a
host: what the JAX package calls a process.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

logger = logging.getLogger(__name__)

DATA_AXIS = "data"
SPACE_AXIS = "space"


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """This rank's place on the (data, space) mesh.

    ``devices`` holds one device per rank of this node (``devices[i]`` is
    local rank i's); ranks are numbered node by node.  With ``n_space`` 1
    global row ``r * b + i`` of a global batch of ``world_size * b`` rows
    is row ``i`` of rank ``r``; above 1, the ``n_space`` ranks of data row
    ``d`` all hold rows ``d * b .. (d + 1) * b`` and split their X extent.
    ``group`` is the process group of every rank (None: the default one),
    ``space_group`` that of this rank's data row, ``data_group`` that of
    the ranks at its space index (None where the axis has one rank).
    """

    rank: int = 0
    world_size: int = 1
    devices: Tuple[torch.device, ...] = (torch.device("cpu"),)
    node_index: int = 0
    node_count: int = 1
    group: Optional[object] = None
    n_space: int = 1
    space_group: Optional[object] = None
    data_group: Optional[object] = None

    def __post_init__(self):
        if self.world_size % self.node_count:
            raise ValueError(f"{self.world_size} ranks do not split evenly over "
                             f"{self.node_count} nodes")
        if len(self.devices) != self.world_size // self.node_count:
            raise ValueError(f"{len(self.devices)} devices for "
                             f"{self.world_size // self.node_count} ranks a node")
        if self.n_space < 1 or self.world_size % self.n_space:
            raise ValueError(f"{self.world_size} ranks not divisible by "
                             f"n_space={self.n_space}")

    @property
    def n_data(self) -> int:
        return self.world_size // self.n_space

    @property
    def data_index(self) -> int:
        return self.rank // self.n_space

    @property
    def space_index(self) -> int:
        return self.rank % self.n_space

    @property
    def spatial(self) -> bool:
        """More than one rank on the space axis: activations are X slabs."""
        return self.n_space > 1

    def space_rank(self, s: int) -> int:
        """The global rank at space index ``s`` of this rank's data row."""
        return self.data_index * self.n_space + s

    @property
    def ranks_per_node(self) -> int:
        return self.world_size // self.node_count

    @property
    def local_rank(self) -> int:
        return self.rank % self.ranks_per_node

    @property
    def device(self) -> torch.device:
        return self.devices[self.local_rank]

    @property
    def parallel(self) -> bool:
        """More than one rank: the reductions below communicate."""
        return self.world_size > 1

    def rows(self, batch: int, within_node: bool = False) -> slice:
        """This rank's rows of a ``batch`` drawn for every rank (the global
        batch) or, ``within_node``, for this node's ranks: those of its
        data index, which every rank of a data row shares."""
        share = (self.ranks_per_node if within_node else self.world_size) // self.n_space
        index = (self.local_rank if within_node else self.rank) // self.n_space
        if batch % share:
            raise ValueError(f"a batch of {batch} does not split evenly over {share} ranks")
        n = batch // share
        return slice(index * n, (index + 1) * n)

    def all_sum(self, t: torch.Tensor, space: bool = False) -> torch.Tensor:
        """The sum of ``t`` over every rank (``space``: over this rank's
        data row), differentiable: the backward all-reduces the incoming
        gradient too, so each rank's gradient of a loss built on global
        sums is ``world_size`` times its share of the true one, which
        ``average_gradients`` takes back."""
        if not (self.spatial if space else self.parallel):
            return t
        from torch.distributed import group as dist_group
        from torch.distributed.nn.functional import all_reduce

        group = self.space_group if space else self.group
        return all_reduce(t, group=group if group is not None else dist_group.WORLD)

    def space_sum_(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` replaced in place by its sum over this rank's data row (the
        space axis), outside autograd; the identity on a one-rank axis."""
        if self.spatial:
            import torch.distributed as dist

            dist.all_reduce(t, group=self.space_group)
        return t

    def count_sum(self, n: int) -> int:
        """The sum of ``n`` over every rank: a global element count where
        slabs may differ in length (with ``n_space`` 1 every rank holds
        the same count and nothing is sent)."""
        if not self.parallel:
            return n
        if not self.spatial:
            return n * self.world_size
        import torch.distributed as dist

        t = torch.tensor([n], dtype=torch.int64, device=self.collective_device())
        dist.all_reduce(t, group=self.group)
        return int(t.item())

    def collective_device(self) -> torch.device:
        """Where a small tensor for a collective lives: the CPU on gloo
        (it takes CUDA tensors only for some collectives), else this rank's
        device."""
        import torch.distributed as dist

        return torch.device("cpu") if dist.get_backend(self.group) == "gloo" else self.device

    def average_gradients(self, grads: Sequence[torch.Tensor]) -> None:
        """Replace each gradient with its mean over the ranks, in one
        all-reduce a dtype; after it every rank holds the same bits."""
        if not self.parallel:
            return
        import torch.distributed as dist

        by_dtype = {}
        for g in grads:
            by_dtype.setdefault(g.dtype, []).append(g)
        for same in by_dtype.values():
            flat = torch.cat([g.reshape(-1) for g in same])
            dist.all_reduce(flat, group=self.group)
            flat.div_(self.world_size)
            torch._foreach_copy_(same, [v.view_as(g) for v, g in
                                        zip(flat.split([g.numel() for g in same]), same)])

    def broadcast_(self, tensors: Sequence[torch.Tensor], src: int = 0) -> None:
        """Overwrite ``tensors`` on every rank with rank ``src``'s."""
        if not self.parallel:
            return
        import torch.distributed as dist

        with torch.no_grad():
            for t in tensors:
                dist.broadcast(t, src=src, group=self.group)


def make_mesh(device=None, devices: Optional[Sequence] = None,
              node_count: Optional[int] = None, n_data: Optional[int] = None,
              n_space: int = 1) -> DataMesh:
    """The ``DataMesh`` of this process: ``n_data x n_space`` ranks.

    Without an initialised process group it is the one-rank mesh on
    ``device`` (default: ``devices[0]``, else ``resolve_device(None)``:
    CUDA, raising where there is none), so one-device and parallel code
    share one path.  Inside a group its rank and world size are the
    group's, which must equal ``n_data * n_space`` (``n_data`` None: the
    world over ``n_space``); ``node_count`` defaults to one node;
    ``devices`` (one per rank of the node) defaults to ``device`` repeated
    on the CPU and to ``cuda:i`` for local rank i on CUDA.  With
    ``n_space`` above 1 every rank creates the process group of every data
    row and of every space index, in the same order.
    """
    import torch.distributed as dist

    from tpu_mednet_torch._device import resolve_device

    device = resolve_device(devices[0] if device is None and devices else device)
    if not (dist.is_available() and dist.is_initialized()):
        if (n_data or 1) * n_space != 1:
            raise ValueError(f"mesh {n_data}x{n_space} needs {(n_data or 1) * n_space} "
                             "ranks, have 1 (no process group)")
        return DataMesh(devices=(device,))
    world, rank = dist.get_world_size(), dist.get_rank()
    if world % n_space:
        raise ValueError(f"{world} devices not divisible by n_space={n_space}")
    if n_data is not None and n_data * n_space != world:
        raise ValueError(f"mesh {n_data}x{n_space} needs {n_data * n_space} ranks, "
                         f"the group has {world}")
    nodes = node_count or 1
    per_node = world // nodes
    if devices is None:
        devices = ([torch.device("cuda", i) for i in range(per_node)] if device.type == "cuda"
                   else [device] * per_node)
    space_group = data_group = None
    if n_space > 1:
        rows = [dist.new_group(list(range(d * n_space, (d + 1) * n_space)))
                for d in range(world // n_space)]
        cols = [dist.new_group(list(range(s, world, n_space))) for s in range(n_space)]
        space_group, data_group = rows[rank // n_space], cols[rank % n_space]
    return DataMesh(rank=rank, world_size=world, devices=tuple(torch.device(d) for d in devices),
                    node_index=rank // per_node, node_count=nodes, n_space=n_space,
                    space_group=space_group, data_group=data_group)


class SlabPlan(NamedTuple):
    """The X slabs of one extent over the space axis: ``lengths[s]`` rows
    from ``offsets[s]`` at space index ``s``."""

    lengths: Tuple[int, ...]
    offsets: Tuple[int, ...]

    def slab(self, s: int) -> slice:
        return slice(self.offsets[s], self.offsets[s] + self.lengths[s])


def slab_plan(extent: int, n_space: int, quantum: int = 1) -> SlabPlan:
    """Split an X ``extent`` over ``n_space`` ranks into lengths that are
    multiples of ``quantum`` (the U-Net's pooling factor 2^(levels-1)), as
    even as possible, the longer slabs first: 96 over 4 at 16 gives (32,
    32, 16, 16).  The counterpart of ``spatial_sharding``: GSPMD splits 96
    into 4 x 24 and lets pooling windows cross shards; whole windows in
    every slab keep pooling and the nearest resize local, and the function
    computed is the same."""
    extent, n_space, quantum = int(extent), int(n_space), int(quantum)
    if extent % quantum:
        raise ValueError(f"X extent {extent} is not a multiple of the pooling factor "
                         f"{quantum}: no split keeps every pooling window on one rank")
    if extent < n_space * quantum:
        raise ValueError(f"X extent {extent} cannot give each of {n_space} ranks a slab of "
                         f"at least the pooling factor {quantum}")
    units, rem = divmod(extent // quantum, n_space)
    lengths = tuple((units + (s < rem)) * quantum for s in range(n_space))
    offsets = tuple(sum(lengths[:s]) for s in range(n_space))
    return SlabPlan(lengths, offsets)


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def shard_subject_keys(keys: Sequence[str], process_index: int = 0,
                       process_count: int = 1) -> list:
    """Per-node subject keys for a host sampler, round-robin.

    Each node samples only its own share, and its ranks split the node's
    batches.  When ``len(keys)`` does not divide evenly, the trailing
    remainder is DROPPED with a warning so every node gets the same share:
    nodes with different epoch lengths would leave one waiting forever in
    a collective the others have passed.  A share of zero is refused.
    """
    pi, pc = process_index, process_count
    keys = list(keys)
    if pc > 1 and keys and len(keys) < pc:
        raise ValueError(
            f"{len(keys)} subject keys cannot be shared across {pc} "
            f"processes (every process would get 0); use fewer processes "
            f"or more subjects"
        )
    rem = len(keys) % pc
    if pc > 1 and rem:
        logger.warning(
            "dropping %d of %d subject keys so all %d processes get an "
            "equal share (%d each) — unequal per-host epoch lengths would "
            "deadlock the cross-host collectives",
            rem, len(keys), pc, len(keys) // pc,
        )
        keys = keys[: len(keys) - rem]
    return [k for i, k in enumerate(keys) if i % pc == pi]
