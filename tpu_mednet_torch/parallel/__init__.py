"""Multi-GPU of the port: the (data, space) mesh (``mesh.py``), the halo
exchange between X slabs (``halo.py``) and joining or launching the ranks
(``multihost.py``)."""

from tpu_mednet_torch.parallel.halo import (SpaceAxis, crop_halo, halo_exchange,
                                            spatially_sharded_apply)
from tpu_mednet_torch.parallel.mesh import (DATA_AXIS, SPACE_AXIS, DataMesh, SlabPlan,
                                            make_mesh, pad_to_multiple, shard_subject_keys,
                                            slab_plan)
from tpu_mednet_torch.parallel.multihost import (assemble_global_batch, join_or_launch,
                                                 launch_local, local_batch_size,
                                                 maybe_initialize_distributed)

__all__ = ["DATA_AXIS", "SPACE_AXIS", "DataMesh", "SlabPlan", "SpaceAxis",
           "assemble_global_batch", "crop_halo", "halo_exchange", "join_or_launch",
           "launch_local", "local_batch_size", "make_mesh", "maybe_initialize_distributed",
           "pad_to_multiple", "shard_subject_keys", "slab_plan", "spatially_sharded_apply"]
