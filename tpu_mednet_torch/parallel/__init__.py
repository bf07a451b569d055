"""Data parallelism of the port: the data axis (``mesh.py``) and joining or
launching its ranks (``multihost.py``)."""

from tpu_mednet_torch.parallel.mesh import (DataMesh, make_mesh, pad_to_multiple,
                                            shard_subject_keys)
from tpu_mednet_torch.parallel.multihost import (assemble_global_batch, join_or_launch,
                                                 launch_local, local_batch_size,
                                                 maybe_initialize_distributed)

__all__ = ["DataMesh", "assemble_global_batch", "join_or_launch", "launch_local",
           "local_batch_size", "make_mesh", "maybe_initialize_distributed", "pad_to_multiple",
           "shard_subject_keys"]
