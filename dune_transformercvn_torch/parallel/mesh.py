"""Data parallelism over processes: the port of the JAX package's 1-D data
mesh (``dune_transformercvn_tpu/parallel/mesh.py``).

The JAX package shards each global batch along axis 0 over a "data" mesh
axis and reduces gradients, metrics and BatchNorm statistics with ``psum``
inside ``shard_map``.  The port runs one process per device through
``torch.distributed`` (``nccl`` on the card, ``gloo`` on the CPU): rank
``r`` owns data shard ``r`` of every global batch, and the reductions are
all-reduces over the default process group.  The caller initialises that
group (``torchrun``'s ``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR``, or
``init_process_group`` with an explicit address), as the JAX package's
caller runs ``jax.distributed.initialize``; with no group the world is one
process and nothing here communicates.

Not ported yet: tensor parallelism (the JAX package's ``state_shardings``,
``is_hybrid`` and ``tp_rows_process_local``), ROADMAP.md §1 item 19.
"""

from __future__ import annotations

import os
from datetime import timedelta
from types import SimpleNamespace
from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

# how long a collective waits for the other ranks (a validation or a
# checkpoint save on rank 0 holds the others at a barrier)
GROUP_TIMEOUT = timedelta(minutes=10)


def init_from_env(device_type: str) -> bool:
    """Initialise the default process group from ``torchrun``'s environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``): ``nccl``
    with ``cuda:LOCAL_RANK`` for ``device_type`` "cuda", else ``gloo``.
    One all-reduce follows at once, while the ranks are still in step, so
    the first collective of the training step does not meet the group's
    rendezvous deadline after ranks drifted apart.  Returns False, doing
    nothing, when the variables are not set."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return False
    device = torch.device("cpu")
    if device_type == "cuda":
        device = torch.device("cuda", local_rank())
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            timeout=GROUP_TIMEOUT)
    dist.all_reduce(torch.zeros(1, device=device))
    return True


def world() -> Tuple[int, int]:
    """``(world size, rank)`` of the default process group; ``(1, 0)``
    without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def local_rank() -> int:
    """The process's index among those of its host (``torchrun``'s
    ``LOCAL_RANK``; 0 without it): the card it drives is ``cuda:LOCAL_RANK``."""
    return int(os.environ.get("LOCAL_RANK", 0))


def data_parallel_size(num_devices) -> int:
    """The number of data shards for ``options.num_gpu``: the world size,
    one device per process.  As the JAX package's ``create_mesh`` does, a
    request above the devices available is clamped with a note, and 0 or
    ``None`` means all of them; a request below the world size would leave
    processes without a shard and raises."""
    size, _ = world()
    if num_devices and num_devices > 0:
        if num_devices > size:
            print(f"Requested {num_devices} devices but only {size} available; clamping.")
        elif num_devices < size:
            raise ValueError(
                f"num_gpu={num_devices} is below the {size} processes of the "
                "process group: each process trains one device, so launch "
                "num_gpu processes (or set num_gpu to 0 for all of them)")
    return size


def shard_ids_of(devices_flat, process_index: int) -> list:
    """Positions along the data axis owned by ``process_index``: shard ``s``
    of the global batch belongs to the process hosting device ``s`` (only
    ``.process_index`` is consulted)."""
    return [s for s, d in enumerate(devices_flat) if d.process_index == process_index]


def local_shard_ids() -> list:
    """The data shards this process feeds: one device per process, so rank
    ``r`` holds data-axis position ``r``."""
    size, rank = world()
    return shard_ids_of([SimpleNamespace(process_index=r) for r in range(size)], rank)


def local_batch_rows(array: np.ndarray, num_shards: int,
                     shard_ids: Sequence[int]) -> np.ndarray:
    """Rows of a ``[num_shards * per_shard, ...]`` global batch that this
    process feeds, concatenated in shard order."""
    per_shard = array.shape[0] // num_shards
    return np.concatenate([array[s * per_shard:(s + 1) * per_shard] for s in shard_ids])


def all_reduce_(tensors: Sequence[torch.Tensor]) -> None:
    """Sum each of ``tensors`` over the process group in place, with one
    all-reduce of their flattened concatenation."""
    tensors = list(tensors)
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    dist.all_reduce(flat)
    pieces = flat.split([t.numel() for t in tensors])
    torch._foreach_copy_(tensors, [piece.view_as(t) for piece, t in zip(pieces, tensors)])


def all_gather_rows(tensors: Sequence[torch.Tensor]) -> List[np.ndarray]:
    """Each of ``tensors`` (leading axis: this rank's rows; the same shapes
    on every rank) with the rows of every rank stacked in rank order, as
    host arrays of the same dtype; one all-gather for all of them."""
    size, _ = world()
    rows = tensors[0].shape[0]
    # nccl gathers on the card; gloo gathers only host tensors
    device = tensors[0].device if dist.get_backend() == "nccl" else torch.device("cpu")
    flat = torch.cat([t.reshape(rows, -1).to(device, torch.float64) for t in tensors], 1)
    parts = [torch.empty_like(flat) for _ in range(size)]
    dist.all_gather(parts, flat)
    pieces = torch.cat(parts).cpu().split([t[0].numel() for t in tensors], dim=1)
    return [piece.reshape(size * rows, *t.shape[1:]).to(t.dtype).numpy()
            for piece, t in zip(pieces, tensors)]


def barrier() -> None:
    """Wait for every rank (no-op in a world of one)."""
    if world()[0] > 1:
        dist.barrier()
