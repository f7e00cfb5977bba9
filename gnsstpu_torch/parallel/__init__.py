"""Device meshes and the sharded receiver (port of gnsstpu/parallel/):
channel-sharded tracking (one K1 launch per shard), sharded acquisition
and the time-block long coherent search on torch.distributed."""

from gnsstpu_torch.parallel.mesh import (  # noqa: F401
    make_distributed_mesh,
    make_mesh,
    shard_acquisition_inputs,
    shard_channel_state,
)
from gnsstpu_torch.parallel.fused_shard import (  # noqa: F401
    make_sharded_fused_tracker,
    shard_fused_inputs,
)
