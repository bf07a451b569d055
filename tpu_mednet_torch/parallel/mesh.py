"""The data axis: ranks, their devices and nodes, and the batch reductions over them.

Counterpart of ``tpu_mednet/parallel/mesh.py`` for the data axis only.
The JAX package builds a ``jax.sharding.Mesh`` over every device and lets
GSPMD shard one global batch, so every batch reduction of the train step
is global.  The port runs one process (a *rank*) per device instead, each
holding its rows of the global batch, and makes the same reductions global
by hand: ``DataMesh.all_sum`` all-reduces a batch sum inside autograd
before the loss divides by it, BatchNorm's statistics go through it, and
``average_gradients`` averages the parameters' gradients after the
backward.  A *node* is a host: what the JAX package calls a process.

Spatial partitioning (the mesh's ``space`` axis, ``parallel/halo.py``)
is not ported yet (ROADMAP §1, "Multi-GPU").
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Optional, Sequence, Tuple

import torch

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """This rank's place on the data axis.

    ``devices`` holds one device per rank of this node (``devices[i]`` is
    local rank i's); ranks are numbered node by node, so global row ``r *
    b + i`` of a global batch of ``world_size * b`` rows is row ``i`` of
    rank ``r``.  ``group`` is the process group (None: the default one).
    """

    rank: int = 0
    world_size: int = 1
    devices: Tuple[torch.device, ...] = (torch.device("cpu"),)
    node_index: int = 0
    node_count: int = 1
    group: Optional[object] = None

    def __post_init__(self):
        if self.world_size % self.node_count:
            raise ValueError(f"{self.world_size} ranks do not split evenly over "
                             f"{self.node_count} nodes")
        if len(self.devices) != self.world_size // self.node_count:
            raise ValueError(f"{len(self.devices)} devices for "
                             f"{self.world_size // self.node_count} ranks a node")

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
        batch) or, ``within_node``, for this node's ranks."""
        share = self.ranks_per_node if within_node else self.world_size
        index = self.local_rank if within_node else self.rank
        if batch % share:
            raise ValueError(f"a batch of {batch} does not split evenly over {share} ranks")
        n = batch // share
        return slice(index * n, (index + 1) * n)

    def all_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over every rank, differentiable: the backward
        all-reduces the incoming gradient too, so each rank's gradient of
        a loss built on global sums is ``world_size`` times its rows' share
        of the true one, which ``average_gradients`` takes back."""
        if not self.parallel:
            return t
        from torch.distributed import group as dist_group
        from torch.distributed.nn.functional import all_reduce

        return all_reduce(t, group=self.group if self.group is not None else dist_group.WORLD)

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
              node_count: Optional[int] = None) -> DataMesh:
    """The ``DataMesh`` of this process.

    Without an initialised process group it is the one-rank mesh on
    ``device`` (default: ``devices[0]``, else the CPU), so one-device and
    data-parallel code share one path.  Inside a group its rank and world
    size are the group's; ``node_count`` defaults to one node; ``devices``
    (one per rank of the node) defaults to ``device`` repeated on the CPU
    and to ``cuda:i`` for local rank i on CUDA.
    """
    import torch.distributed as dist

    if device is None:
        device = devices[0] if devices else "cpu"
    device = torch.device(device)
    if not (dist.is_available() and dist.is_initialized()):
        return DataMesh(devices=(device,))
    world, rank = dist.get_world_size(), dist.get_rank()
    nodes = node_count or 1
    per_node = world // nodes
    if devices is None:
        devices = ([torch.device("cuda", i) for i in range(per_node)] if device.type == "cuda"
                   else [device] * per_node)
    return DataMesh(rank=rank, world_size=world, devices=tuple(torch.device(d) for d in devices),
                    node_index=rank // per_node, node_count=nodes)


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
