"""Multi-process set-up: joining the process group, batch shares, local launches.

Counterpart of ``tpu_mednet/parallel/multihost.py``.  Where the JAX
package starts ``jax.distributed`` from its ``JAX_*`` variables so one
process per host sees every device, the port runs one process per device
and joins a ``torch.distributed`` group from the variables ``torchrun``
sets (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
``LOCAL_RANK``; ``LOCAL_WORLD_SIZE`` gives the ranks a node).  The backend
is the caller's: NCCL for ranks on CUDA devices, gloo for ranks on the CPU
(or for ranks that share a card, which NCCL refuses).  ``launch_local``
starts the ranks of one node itself when no launcher did.
"""

from __future__ import annotations

import importlib
import logging
import os
import socket
import sys
from typing import Dict, Optional, Sequence

import numpy as np
import torch

logger = logging.getLogger(__name__)

ENV_VARS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")


def distributed_env(env=None) -> Optional[Dict[str, str]]:
    """The launcher's variables, or None when none is set; raises on a
    partial set (run on as independent one-process jobs, every process
    would train the full global batch and race on the checkpoints)."""
    env = os.environ if env is None else env
    got = {k: env.get(k) for k in ENV_VARS}
    if not any(v not in (None, "") for v in got.values()):
        return None
    if any(v in (None, "") for v in got.values()):
        raise ValueError(
            "incomplete multi-process environment: need ALL of "
            f"{', '.join(ENV_VARS)} "
            f"(got {', '.join(f'{k}={v!r}' for k, v in got.items())})"
        )
    return got


def maybe_initialize_distributed(backend: str = "nccl", env=None) -> bool:
    """Join the process group the launcher's variables describe; return
    whether this process is in a group of more than one rank.

    No variables: returns False without touching ``torch.distributed``.  A
    group already initialised (by an earlier call) is kept.
    """
    import torch.distributed as dist

    got = distributed_env(env)
    if got is None:
        return False
    world, rank = int(got["WORLD_SIZE"]), int(got["RANK"])
    if world <= 1:
        return False
    if not dist.is_initialized():
        dist.init_process_group(
            backend, init_method=f"tcp://{got['MASTER_ADDR']}:{got['MASTER_PORT']}",
            world_size=world, rank=rank)
        logger.info("torch.distributed (%s) initialized: rank %d/%d", backend,
                    dist.get_rank(), dist.get_world_size())
    return True


def node_count(env=None) -> int:
    """Nodes of the launcher's group: ``WORLD_SIZE / LOCAL_WORLD_SIZE``
    (one node where the launcher does not say)."""
    env = os.environ if env is None else env
    world = int(env.get("WORLD_SIZE", 1))
    per_node = int(env.get("LOCAL_WORLD_SIZE") or world)
    if world % per_node:
        raise ValueError(f"WORLD_SIZE {world} is not a multiple of LOCAL_WORLD_SIZE "
                         f"{per_node}")
    return world // per_node


def local_batch_size(global_batch_size: int, nodes: int = 1) -> int:
    """Rows of the global batch each of ``nodes`` nodes must produce."""
    pc = nodes
    if global_batch_size % pc != 0:
        raise ValueError(
            f"global batch size {global_batch_size} not divisible by "
            f"{pc} processes"
        )
    return global_batch_size // pc


def take_rows(batch: Dict[str, object], rows: slice) -> Dict[str, object]:
    """A batch's entries cut to ``rows`` along the batch axis."""
    return {k: v[rows] if isinstance(v, (torch.Tensor, np.ndarray, list)) else v
            for k, v in batch.items()}


def assemble_global_batch(batch: Dict[str, torch.Tensor], mesh,
                          array_keys=("data", "label")) -> Dict[str, torch.Tensor]:
    """Every rank's rows of ``array_keys`` gathered, in rank order, into
    the global batch on each rank (the identity on one rank)."""
    out = dict(batch)
    if not mesh.parallel:
        return out
    import torch.distributed as dist

    for k in array_keys:
        if k in out:
            local = out[k].contiguous()
            parts = [torch.empty_like(local) for _ in range(mesh.world_size)]
            dist.all_gather(parts, local, group=mesh.group)
            out[k] = torch.cat(parts)
    return out


def free_port() -> int:
    """A TCP port on localhost that was free a moment ago."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_entry(local_rank: int, module: str, argv: Sequence[str], nprocs: int,
                port: int) -> None:
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE=str(nprocs),
                      RANK=str(local_rank), LOCAL_RANK=str(local_rank),
                      LOCAL_WORLD_SIZE=str(nprocs))
    rc = importlib.import_module(module).main(list(argv))
    if rc:
        sys.exit(rc)


def launch_local(module: str, argv: Sequence[str], nprocs: int) -> int:
    """Run ``module.main(argv)`` in ``nprocs`` new processes, the ranks of
    one node, with the launcher's variables set; return the first nonzero
    exit code, else 0.  A rank that fails ends the others."""
    import torch.multiprocessing as mp

    try:
        mp.start_processes(_rank_entry, args=(module, list(argv), nprocs, free_port()),
                           nprocs=nprocs, join=True, start_method="spawn")
    except mp.ProcessExitedException as exc:
        return exc.exit_code or 1
    except mp.ProcessRaisedException as exc:  # the rank's traceback, then a failure
        print(exc, file=sys.stderr)
        return 1
    return 0


def _space_shards(hparams, n_devices: int) -> int:
    """``--spatial_shards``, refused with the JAX CLIs' words where it does
    not divide the device count."""
    n_space = max(int(getattr(hparams, "spatial_shards", 1) or 1), 1)
    if n_devices % n_space:
        raise SystemExit(
            f"--spatial_shards {n_space} must divide the device count "
            f"({n_devices})"
        )
    return n_space


def join_or_launch(module: str, argv: Sequence[str], hparams, device: torch.device,
                   task: str):
    """The training CLIs' mesh: ``(mesh, None)`` to train as one rank, or
    ``(None, exit code)`` once this process has run the ranks itself.

    Under a launcher's variables the process joins that group (NCCL on
    CUDA, gloo on the CPU) and trains on ``cuda:LOCAL_RANK``.  Otherwise
    ``--gpus`` is clamped to the CUDA devices visible, as the JAX CLIs
    clamp it to ``len(jax.devices())``, and the clamp is printed (on the
    CPU, ``--gpus N`` is N gloo ranks, the counterpart of the JAX tests'
    virtual CPU devices); above one, ``launch_local`` runs the ranks.
    ``--spatial_shards`` S must divide the ranks, which form an (N / S) x S
    (data, space) mesh, and ``--batch_size`` must split evenly over its
    data axis, either way."""
    from tpu_mednet_torch.config import validate_task_config
    from tpu_mednet_torch.parallel.mesh import DataMesh, make_mesh

    name = module.rsplit(".", 1)[-1]
    if maybe_initialize_distributed("nccl" if device.type == "cuda" else "gloo"):
        if device.type == "cuda":
            device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
            torch.cuda.set_device(device)
        n_space = _space_shards(hparams, int(os.environ["WORLD_SIZE"]))
        mesh = make_mesh(device, node_count=node_count(), n_space=n_space)
        if hparams.gpus != mesh.world_size:
            logger.info("--gpus %d: training as rank %d of the launcher's %d", hparams.gpus,
                        mesh.rank, mesh.world_size)
        validate_task_config(hparams, task, n_data=mesh.n_data)
        return mesh, None
    n = max(int(hparams.gpus), 1)
    if device.type == "cuda" and n > torch.cuda.device_count():
        n = torch.cuda.device_count()
        print(f"{name}: --gpus {hparams.gpus} clamped to {n}, the CUDA devices visible",
              flush=True)
    validate_task_config(hparams, task, n_data=n // _space_shards(hparams, n))
    if n > 1:
        return None, launch_local(module, argv, n)
    return DataMesh(devices=(device,)), None
