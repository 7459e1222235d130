"""Multi-process runs (port of ``ivf_tpu/parallel/multihost.py``).

A JAX process becomes a port *node*: the ranks that share a host
(``LOCAL_WORLD_SIZE`` under ``torchrun``; the whole world when it is not
set). A JAX device becomes a *rank*: one process on one device.

  * ``initialize()`` joins the process group (``dist.init_process_group``):
    NCCL with the rank's card made current first, or gloo when the caller
    asks for the CPU; nothing falls back from one to the other;
  * each node loads a disjoint shard of the dataset (``process_shard`` /
    ``ShardedDataset``, by node index and count);
  * ``global_device_batch`` puts this rank's rows of its node's batch on
    its device. ``cfg.data.batch_size`` is the node's batch: on one node
    the global batch, split over its ranks; across nodes the global batch
    is ``batch_size * nodes`` (``ivf_tpu/parallel/multihost.py:123-131``).

The mask search needs no collective across clips, so besides its mesh
layout (``api.find_masks(mesh=...)``: every rank runs the same driver and
searches its rows of each batch) it runs as independent drivers, one per
process over ``ShardedDataset(even=False)``, with no process group at all.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids=None,
    device=None,
    timeout_s: float = 600.0,
) -> bool:
    """Join the process group. The arguments fall back to ``torchrun``'s
    ``MASTER_ADDR`` / ``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK``, then to
    the JAX package's ``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` /
    ``JAX_PROCESS_ID``. ``coordinator_address`` is ``host:port`` or a
    ``tcp://`` / ``file://`` init method. ``device`` None runs the ranks on
    cards over NCCL (the rank's card is ``local_device_ids[0]``, else
    ``LOCAL_RANK``, else the rank modulo the cards, made current before
    anything is allocated); ``device="cpu"`` runs them on the CPU over
    gloo.

    Returns True when the world has more than one rank. With no
    coordinator anywhere it is a no-op that returns False; once joined, a
    second call returns what the first did."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    env = os.environ
    torchrun = coordinator_address is None and "MASTER_ADDR" in env and "MASTER_PORT" in env
    if coordinator_address is None and not torchrun:
        coordinator_address = env.get("JAX_COORDINATOR_ADDRESS")
        if coordinator_address is None:
            return False
    if num_processes is None:
        num_processes = int(env.get("WORLD_SIZE") or env.get("JAX_NUM_PROCESSES") or 1)
    if process_id is None:
        process_id = int(env.get("RANK") or env.get("JAX_PROCESS_ID") or 0)
    if torchrun:
        init_method = "env://"  # the agent's store, as torchrun set it up
    elif coordinator_address.startswith(("tcp://", "file://")):
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    kwargs = {}
    if device is None or torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "ivf_tpu_torch runs its ranks on CUDA devices over NCCL and none is available; "
                "pass device='cpu' to run them on the CPU over gloo"
            )
        if local_device_ids:
            local = int(local_device_ids[0])
        else:
            local = int(env.get("LOCAL_RANK", process_id % torch.cuda.device_count()))
        torch.cuda.set_device(local)
        backend, kwargs["device_id"] = "nccl", torch.device("cuda", local)
    elif torch.device(device).type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"device {device!r}: cuda (NCCL) or cpu (gloo)")
    dist.init_process_group(
        backend, init_method=init_method, world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s), **kwargs,
    )
    return dist.get_world_size() > 1


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def local_world_size() -> int:
    """The ranks of one node: ``LOCAL_WORLD_SIZE``, else the whole world."""
    return int(os.environ.get("LOCAL_WORLD_SIZE") or world_size())


def node_count() -> int:
    world, local = world_size(), local_world_size()
    if world % local:
        raise ValueError(f"a world of {world} ranks is no whole number of {local}-rank nodes")
    return world // local


def node_index() -> int:
    return rank() // local_world_size()


def process_shard(
    n_items: int,
    process_index: Optional[int] = None,
    process_count: Optional[int] = None,
    even: bool = False,
) -> range:
    """This node's contiguous share of ``n_items`` dataset items (by default
    ``node_index()`` of ``node_count()``).

    ``even=False``: balanced cover — the first ``n_items % count`` nodes
    take one extra item; the shards are disjoint and cover everything
    (independent per-process work, the mask-search layout). ``even=True``:
    every shard is exactly ``n_items // count`` items, the tail dropped —
    required where ranks step together: an extra batch on one node would
    be a collective the others never join."""
    i = node_index() if process_index is None else process_index
    c = node_count() if process_count is None else process_count
    if not 0 <= i < c:
        raise ValueError(f"process_index {i} out of range for count {c}")
    base, rem = divmod(n_items, c)
    if even:
        return range(i * base, (i + 1) * base)
    start = i * base + min(i, rem)
    return range(start, start + base + (1 if i < rem else 0))


class ShardedDataset:
    """View of any indexable dataset restricted to one node's shard
    (``process_shard``), forwarding ``get_payloads`` (the native decode)
    where the dataset has it and every other attribute. The default
    ``even=True`` gives every node the same number of steps an epoch;
    ``even=False`` covers every item (independent drivers)."""

    def __init__(
        self,
        dataset,
        process_index: Optional[int] = None,
        process_count: Optional[int] = None,
        even: bool = True,
    ):
        self.dataset = dataset
        self.indices = process_shard(len(dataset), process_index, process_count, even=even)
        # only where the wrapped dataset has it: ClipLoader checks hasattr
        if hasattr(dataset, "get_payloads"):
            self.get_payloads = lambda index: dataset.get_payloads(self.indices[index])

    def __len__(self) -> int:
        return len(self.indices)

    def __getitem__(self, index: int):
        return self.dataset[self.indices[index]]

    def __getattr__(self, name):  # catalog metadata etc. pass through
        if name.startswith("__") or name in ("dataset", "indices"):
            raise AttributeError(name)
        return getattr(object.__getattribute__(self, "dataset"), name)


def global_device_batch(batch, mesh):
    """This rank's rows of its node's batch (a tuple of numpy arrays and
    host entries) on its device, as plain tensors (the hand kernels launch
    on ``data_ptr()``, so never a ``DTensor``); non-array entries (ids)
    pass as they are. The global batch is the nodes' batches in node
    order."""
    from ivf_tpu_torch.parallel.mesh import mesh_device, node_rows

    n = next(x.shape[0] for x in batch if isinstance(x, np.ndarray))
    rows, dev = node_rows(mesh, n), mesh_device(mesh)
    return tuple(torch.from_numpy(np.ascontiguousarray(x[rows])).to(dev) if isinstance(x, np.ndarray) else x
                 for x in batch)
