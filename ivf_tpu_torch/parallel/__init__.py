"""Parallelism of the port over ``torch.distributed`` (port of
``ivf_tpu/parallel/``, with its names).

The mapping from the JAX package:

  * a JAX *device* is a port *rank*: one process on one device (its card,
    made current before anything is allocated, over NCCL; or the CPU over
    gloo when the caller asks for it; nothing falls back from one to the
    other);
  * a JAX *process* is a port *node*: the ranks that share a host
    (``LOCAL_WORLD_SIZE`` under ``torchrun``, else the whole world);
  * a mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over every
    rank of the world with the JAX axis names: ``'data'``, ``('data',
    'model')``, ``('slice', 'data')``, ``'stage'``. ``get_mesh(n)`` raises
    unless ``n`` is the world size (or None);
  * ``cfg.data.batch_size`` keeps its meaning per node: on one node it is
    the global batch and each rank decodes and runs its contiguous rows
    of every batch, in the global order; across nodes each node reads its
    ``ShardedDataset(even=True)`` shard, and the global batch is
    ``batch_size * nodes``. A batch the node's data axis does not divide
    raises;
  * where XLA inserts collectives for a mesh, the port writes them out:
    the gradient all-reduce of the train step, the synchronised BatchNorm
    statistics (``models/layers.py::set_batch_stats_group``), the gathers
    of ``evaluate`` and of ``find_masks`` (``collectives.py``), the
    pipeline's sends and receives, the tensor-parallel channel gathers.

``tensor_parallel_variables`` (placing a variable tree) becomes
``tensor_parallel`` (slicing a module in place). Importing this package
starts no process group and touches no device:
``initialize_multihost`` (``multihost.initialize``) does. Spatial sharding
(``spatial_sharding``) raises: ROADMAP.md, Queue 1 item 13b.
"""

from ivf_tpu_torch.parallel.collectives import all_gather_along, all_reduce_sum
from ivf_tpu_torch.parallel.mesh import (
    batch_group,
    batch_position,
    data_sharding,
    get_2d_mesh,
    get_mesh,
    get_multislice_mesh,
    mesh_device,
    multislice_sharding,
    replicate,
    shard_batch,
    spatial_sharding,
    tensor_parallel,
)
from ivf_tpu_torch.parallel.multihost import (
    ShardedDataset,
    global_device_batch,
    initialize as initialize_multihost,
    process_shard,
)
from ivf_tpu_torch.parallel.pipeline import i3d_stage_fns, pipeline_apply, stage_io_shapes

__all__ = [
    "ShardedDataset",
    "all_gather_along",
    "all_reduce_sum",
    "batch_group",
    "batch_position",
    "data_sharding",
    "get_2d_mesh",
    "get_mesh",
    "get_multislice_mesh",
    "global_device_batch",
    "i3d_stage_fns",
    "initialize_multihost",
    "mesh_device",
    "multislice_sharding",
    "pipeline_apply",
    "process_shard",
    "replicate",
    "shard_batch",
    "spatial_sharding",
    "stage_io_shapes",
    "tensor_parallel",
]
