"""The port's multi-device layer: meshes, shardings, replicas, row strips."""

from . import halo, mesh, replicas
from .mesh import (
    Mesh,
    RemoteDevice,
    Sharding,
    batch_sharding,
    create_hybrid_mesh,
    create_mesh,
    crnn_param_sharding,
    hybrid_batch_sharding,
    initialize_distributed,
    local_rows,
    process_count,
    process_index,
    replicated,
    shard_batch,
    shard_params,
    spatial_sharding,
    strip_bounds,
)
