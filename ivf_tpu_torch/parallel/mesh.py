"""Device meshes and batch placement over ``torch.distributed`` (port of
``ivf_tpu/parallel/mesh.py``).

A JAX mesh places one process's arrays over many devices and XLA inserts
the collectives; here every rank is one process on one device, a mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over every rank of the world
with the JAX axis names, and the collectives are written out
(``collectives.py``, the train step, ``api.find_masks``). The batch axes
are ``'data'`` and, on a multi-slice mesh, ``'slice'`` (flattened
slice-major, as ``ivf_tpu/parallel/mesh.py:85-107`` orders them); a rank's
place along them says which rows of a batch it holds.

Batches stay plain tensors on the rank's device, never ``DTensor``: the
hand kernels launch on ``data_ptr()``. ``data_sharding`` /
``multislice_sharding`` describe the layout as DTensor placements.
``spatial_sharding`` (H over ``'model'``, with halo exchanges before every
SAME conv and pool) is not ported yet (ROADMAP.md, Queue 1 item 13b).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

BATCH_AXES = ("slice", "data")


def _world() -> int:
    if not dist.is_initialized():
        raise RuntimeError(
            "a mesh needs the process group: start the ranks and call "
            "ivf_tpu_torch.parallel.initialize_multihost() (or torch.distributed.init_process_group) first"
        )
    return dist.get_world_size()


def _device_type() -> str:
    """The mesh's device type follows the process group's backend: NCCL
    ranks hold a card each, gloo ranks the CPU."""
    backend = dist.get_backend()
    if backend == "nccl":
        return "cuda"
    if backend == "gloo":
        return "cpu"
    raise ValueError(f"process group backend {backend!r}: nccl (cuda) or gloo (cpu)")


def _mesh(shape: Tuple[int, ...], names: Sequence[str]):
    from torch.distributed.device_mesh import init_device_mesh

    world = _world()
    if math.prod(shape) != world:
        raise ValueError(
            f"a {'x'.join(map(str, shape))} mesh over a world of {world} ranks: every mesh spans every rank"
        )
    return init_device_mesh(_device_type(), tuple(shape), mesh_dim_names=tuple(names))


def get_mesh(n_devices: Optional[int] = None, axis_name: str = "data"):
    """1-D mesh over every rank; ``n_devices`` must be the world size (or
    None)."""
    world = _world()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"requested a {n_devices}-rank mesh in a world of {world} ranks")
    return _mesh((world,), (axis_name,))


def get_2d_mesh(data: int, model: int, axis_names: Sequence[str] = ("data", "model")):
    """(data x model) mesh; ``data * model`` must be the world size. The
    'model' axis serves ``tensor_parallel`` (spatial sharding raises)."""
    return _mesh((data, model), axis_names)


def get_multislice_mesh(n_slices: int, chips_per_slice: int, axis_names: Sequence[str] = ("slice", "data")):
    """(slice x data) mesh, slice-major: batches split over both axes."""
    return _mesh((n_slices, chips_per_slice), axis_names)


def mesh_device(mesh) -> torch.device:
    """The rank's device on ``mesh``: its card (``torch.cuda.set_device``
    made it current) or the CPU."""
    _world()
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _batch_axes(mesh) -> list:
    names = list(mesh.mesh_dim_names or ())
    axes = [n for n in names if n in BATCH_AXES]
    if not axes:
        raise ValueError(f"mesh axes {names}: no batch axis ({' or '.join(BATCH_AXES)})")
    return axes


def batch_position(mesh) -> Tuple[int, int]:
    """(index, count) of this rank along the mesh's batch axes, flattened
    slice-major."""
    _world()
    names = list(mesh.mesh_dim_names)
    coord = mesh.get_coordinate()
    index, count = 0, 1
    for axis in _batch_axes(mesh):
        d = names.index(axis)
        index = index * mesh.shape[d] + coord[d]
        count *= mesh.shape[d]
    return index, count


def batch_group(mesh):
    """The process group over the mesh's batch axes: the group that sums
    gradients and BN statistics and gathers predictions. Both batch axes
    of a multi-slice mesh span the world, in rank order."""
    axes = _batch_axes(mesh)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    if len(axes) == len(mesh.mesh_dim_names):
        return dist.group.WORLD
    raise ValueError(f"mesh axes {list(mesh.mesh_dim_names)}: two batch axes beside another axis")


def _rows(n: int, index: int, count: int, what: str) -> slice:
    if n % count:
        raise ValueError(f"a batch of {n} rows does not split over the {count} ranks of {what}")
    per = n // count
    return slice(index * per, (index + 1) * per)


def batch_rows(mesh, n: int) -> slice:
    """This rank's rows of an ``n``-row batch split over every rank of the
    batch axes (``find_masks``, ``shard_batch``)."""
    index, count = batch_position(mesh)
    return _rows(n, index, count, "the data axis")


def node_rows(mesh, n: int) -> slice:
    """This rank's rows of an ``n``-row batch of its node: the node's ranks
    split it (``ClipLoader``, ``global_device_batch``). Nodes hold
    contiguous places of the batch axes."""
    from ivf_tpu_torch.parallel.multihost import node_count, node_index

    index, count = batch_position(mesh)
    nodes = node_count()
    if count % nodes:
        raise ValueError(f"{count} batch places do not split over {nodes} nodes")
    per_node = count // nodes
    local = index - node_index() * per_node
    if not 0 <= local < per_node:
        raise ValueError("the mesh's batch axes do not follow the nodes: a rank's batch place is on another node")
    return _rows(n, local, per_node, "this node's data axis")


def data_sharding(mesh, axis_name: str = "data") -> list:
    """The batch's layout: rows over ``axis_name``, replicated over the
    mesh's other axes (DTensor placements)."""
    from torch.distributed.tensor import Replicate, Shard

    return [Shard(0) if n == axis_name else Replicate() for n in mesh.mesh_dim_names]


def multislice_sharding(mesh) -> list:
    """Rows over every axis of the mesh, slice-major (DTensor placements)."""
    from torch.distributed.tensor import Shard

    return [Shard(0) for _ in mesh.mesh_dim_names]


def spatial_sharding(mesh):
    raise NotImplementedError(
        "spatial_sharding: H over 'model' needs a halo exchange before every TF-SAME conv and pool along H, "
        "with its backward; not ported yet (ROADMAP.md, Queue 1 item 13b)"
    )


def _place(x, rows: slice, device: torch.device):
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x[rows]))
    elif isinstance(x, torch.Tensor):
        x = x[rows]
    else:
        return x  # ids and other host entries pass as they are
    return x.to(device)


def shard_batch(batch, mesh):
    """This rank's rows of a global batch (an array or a tuple of arrays
    and host entries) on the rank's device, as plain tensors."""
    if isinstance(batch, (np.ndarray, torch.Tensor)):
        return _place(batch, batch_rows(mesh, batch.shape[0]), mesh_device(mesh))
    n = next(x.shape[0] for x in batch if isinstance(x, (np.ndarray, torch.Tensor)))
    rows = batch_rows(mesh, n)
    return tuple(_place(x, rows, mesh_device(mesh)) for x in batch)


def replicate(obj, mesh):
    """``obj`` (a module, a tensor or a list or dict of tensors) with rank
    0's values on every rank (a broadcast over the world, which every mesh
    spans), in place; returns ``obj``."""
    if isinstance(obj, torch.nn.Module):
        tensors = [t.data for t in (*obj.parameters(), *obj.buffers())]
    elif isinstance(obj, torch.Tensor):
        tensors = [obj.data]
    elif isinstance(obj, dict):
        tensors = [t.data for t in obj.values()]
    else:
        tensors = [t.data for t in obj]
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t, src=0)
    return obj


def tensor_parallel(model: torch.nn.Module, mesh, axis: str = "model") -> torch.nn.Module:
    """Megatron-style tensor parallelism over ``axis`` (the JAX package's
    ``tensor_parallel_variables``, ``ivf_tpu/parallel/mesh.py:110-128``):
    every ``Unit3D`` whose output channels divide by the axis keeps this
    rank's contiguous slice of its conv weight, bias and BN vectors and
    gathers its output along the channels (``Unit3D.gather``) before any
    consumer. Eval-mode BN folds the slice; the 1x1x1 trio concatenates
    the three units' slices; the pointwise and fused branch-3 kernels take
    the sliced widths. Other layers stay whole. In place; returns
    ``model``."""
    from ivf_tpu_torch.models.layers import Unit3D

    group = mesh.get_group(axis)
    size, rank = dist.get_world_size(group), dist.get_rank(group)

    def sliced(p: torch.nn.Parameter) -> torch.nn.Parameter:
        return torch.nn.Parameter(p[part].clone(), requires_grad=p.requires_grad)

    for mod in model.modules():
        if not isinstance(mod, Unit3D) or mod.tp_group is not None:
            continue
        cout = mod.conv3d.weight.shape[0]
        if cout % size:
            continue
        part = slice(rank * cout // size, (rank + 1) * cout // size)
        with torch.no_grad():
            mod.conv3d.weight = sliced(mod.conv3d.weight)
            if mod.conv3d.bias is not None:
                mod.conv3d.bias = sliced(mod.conv3d.bias)
            if mod.bn is not None:
                mod.bn.weight, mod.bn.bias = sliced(mod.bn.weight), sliced(mod.bn.bias)
                mod.bn.running_mean = mod.bn.running_mean[part].clone()
                mod.bn.running_var = mod.bn.running_var[part].clone()
        mod.tp_group = group
    return model
