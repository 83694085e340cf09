"""Data and tensor parallelism over processes: the port of the JAX package's
mesh (``dune_transformercvn_tpu/parallel/mesh.py``).

The JAX package shards each global batch along axis 0 over a "data" mesh
axis and reduces gradients, metrics and BatchNorm statistics with ``psum``
inside ``shard_map``.  The port runs one process per device through
``torch.distributed`` (``nccl`` on the card, ``gloo`` on the CPU).  The
caller initialises the default group (``torchrun``'s ``RANK`` /
``WORLD_SIZE`` / ``MASTER_ADDR``, or ``init_process_group`` with an explicit
address), as the JAX package's caller runs ``jax.distributed.initialize``;
with no group the world is one process and nothing here communicates.

**The mesh** (:func:`create_mesh`, a :class:`Mesh`).  With
``model_parallel`` 1 every rank is a data shard: rank ``r`` owns shard ``r``
of every global batch and the reductions run over the default group.  With
``model_parallel`` mp > 1 the world is a ``(data, model)`` grid of
``world // mp`` TP rows of ``mp`` adjacent ranks (a
``torch.distributed.device_mesh`` with those dimension names), as JAX's
hybrid mesh is: the ranks of a row hold one data shard between them, and a
row must not span hosts (hosts counted by ``LOCAL_WORLD_SIZE``).

**Tensor parallelism** (:func:`shard_parameters`).  JAX's hybrid mesh keeps
the data axis manual and lets GSPMD partition the model axis: each
parameter whose leaf has >= 2 dims and a last (output-channel) axis that
splits over mp into pieces of at least ``min_shard_dim`` is laid out
channel-sharded (:func:`state_shardings`), and so are its optimizer
moments.  The port holds each such parameter as a ``DTensor`` ``Shard(d)``
over the "model" sub-mesh, where ``d`` is the port's dimension of that JAX
axis (``from_jax.jax_channel_axes``: dim 0 of conv, linear and packed
q/k/v weights, the last dim of position and classifier vectors); the
optimizers make their moments from the parameter, so they follow it.  1-D
scales, biases, BatchNorm statistics and scalars stay plain, replicated
tensors.

The compute gathers, rather than partitioning each product: a forward
pre-hook on the model all-gathers every sharded parameter of the row into a
full tensor (one collective for all of them) and puts it in the module
for the forward; the backward reduce-scatters the full gradients back to
the shards (one collective).  Each rank of a row then computes what one
process computes for the row's data shard, which is JAX's contract
(``tests/test_tensor_parallel.py``), and holds 1/mp of each sharded
parameter and of its moments.  DTensor's own sharding rules were not used
for the products: the port's convolutions and attention read parameters in
their parents' forwards, in float32 parameters cast to the compute dtype,
and a column-parallel layout would also shard the activations that the
masked BatchNorms and PReLUs take whole.  A recompute of ``ops.masked.remat``
gathers its module's parameters again (:func:`gathered_parameters`).

**Gradients.**  The loss carries ``1 / world``.  A sharded gradient comes
back from the reduce-scatter summed over the row's mp copies (so carrying
``1 / dp``) and is then summed over the "data" group.  A replicated
gradient, the metrics and unsynced BatchNorm statistics are summed over
every rank: each row holds mp equal copies of its data shard's values, so
the world sum with ``1 / world`` is the mean over the data shards, and the
replicas of a row come out equal bit for bit even where a kernel on the
card sums in no fixed order.  ``global_norm`` counts each sharded gradient
once (local squares summed over the "model" group).  Sync-BN, the
validation sums and the gathered predictions run over the "data" group.

**Collectives with ``gloo`` on CUDA tensors** (every rank on one card):
the tensor-parallel path needs ``all_gather_into_tensor``,
``reduce_scatter_tensor`` and ``all_reduce``, and ``gloo`` takes all three
on CUDA tensors (probed on an H100 with torch 2.11, PERF.md), so nothing is
staged through host memory.

**Checkpoints** stay layout-independent: :func:`full_tensor` gathers a
sharded tensor (a collective every rank of the row joins), and a full
tensor loaded into a sharded parameter or moment is cut to this rank's
piece (:func:`shard_like`).
"""

from __future__ import annotations

import os
from contextlib import contextmanager
from dataclasses import dataclass
from datetime import timedelta
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

DATA_AXIS = "data"
MODEL_AXIS = "model"

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


def local_world_size(world_size: int) -> int:
    """The processes of this host (``torchrun``'s ``LOCAL_WORLD_SIZE``);
    without it every process is taken to share the host."""
    return int(os.environ.get("LOCAL_WORLD_SIZE", world_size))


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------

def mesh_shape(world_size: int, num_devices=None, model_parallel: int = 1) -> Tuple[int, int]:
    """``(dp, mp)`` for ``options.num_gpu`` and ``options.model_parallel``
    on ``world_size`` processes, one device each, by the JAX package's
    ``create_mesh`` rules: a device request above the world is clamped with
    a note and 0 or ``None`` means all of them (a request below the world
    would leave processes without a shard and raises); an ``mp`` above the
    devices falls back to no tensor parallelism with JAX's note (a
    TP-trained run's options evaluate on fewer devices); an ``mp`` that does
    not divide them raises."""
    if num_devices and num_devices > 0:
        if num_devices > world_size:
            print(f"Requested {num_devices} devices but only {world_size} available; "
                  "clamping.")
        elif num_devices < world_size:
            raise ValueError(
                f"num_gpu={num_devices} is below the {world_size} processes of the "
                "process group: each process trains one device, so launch "
                "num_gpu processes (or set num_gpu to 0 for all of them)")
    mp = max(1, int(model_parallel or 1))
    if mp > world_size:
        print(f"model_parallel={mp} exceeds the {world_size} available device(s); "
              "running without tensor parallelism.")
        mp = 1
    if world_size % mp:
        raise ValueError(
            f"model_parallel={mp} does not divide the {world_size}-device mesh")
    return world_size // mp, mp


def tp_rows_process_local(world_size: int, model_parallel: int,
                          processes_per_host: int) -> bool:
    """True when every TP row (``model_parallel`` adjacent ranks) lives on
    one host, ranks being numbered host by host in blocks of
    ``processes_per_host``: the JAX package's invariant that a data shard
    is a whole TP row on one host, so the row's collectives stay inside
    it."""
    rows = np.arange(world_size).reshape(-1, model_parallel) // processes_per_host
    return bool((rows == rows[:, :1]).all())


@dataclass(frozen=True)
class Mesh:
    """The process layout: ``dp`` data shards of ``mp`` ranks each (a TP
    row), this process being ``rank``.  ``device_mesh`` is the 2-D
    ``(data, model)`` ``DeviceMesh`` when ``mp > 1``."""

    dp: int
    mp: int
    rank: int
    device_mesh: Optional[object] = None

    @property
    def world_size(self) -> int:
        return self.dp * self.mp

    @property
    def data_index(self) -> int:
        """This rank's data shard (its TP row)."""
        return self.rank // self.mp

    @property
    def model_index(self) -> int:
        """This rank's position in its TP row: the piece of each sharded
        parameter it holds."""
        return self.rank % self.mp

    @property
    def data_group(self):
        """The ranks holding this rank's piece of the model, one a data
        shard (the default group without TP; ``None`` in a world of one)."""
        if self.device_mesh is not None:
            return self.device_mesh.get_group(DATA_AXIS)
        return dist.group.WORLD if self.world_size > 1 else None

    @property
    def model_mesh(self):
        """The 1-D "model" sub-mesh sharded parameters are laid out over."""
        return self.device_mesh[MODEL_AXIS]


def create_mesh(num_devices=None, model_parallel: int = 1, device_type: str = "cpu") -> Mesh:
    """The :class:`Mesh` of the default process group for
    ``options.num_gpu`` and ``options.model_parallel`` (:func:`mesh_shape`'s
    rules).  With tensor parallelism it builds the ``(data, model)``
    ``DeviceMesh`` over ``device_type`` and raises when a TP row would span
    hosts, as the JAX Trainer does."""
    size, rank = world()
    dp, mp = mesh_shape(size, num_devices, model_parallel)
    if mp == 1:
        return Mesh(dp, 1, rank)
    if not tp_rows_process_local(size, mp, local_world_size(size)):
        raise ValueError(
            f"model_parallel={mp} does not divide the per-host device count "
            f"({local_world_size(size)}): a TP group would span hosts. Use a "
            "model_parallel that fits within one host; data parallelism spans hosts.")
    from torch.distributed.device_mesh import init_device_mesh

    device_mesh = init_device_mesh(device_type, (dp, mp),
                                   mesh_dim_names=(DATA_AXIS, MODEL_AXIS))
    return Mesh(dp, mp, rank, device_mesh)


def default_mesh() -> Mesh:
    """The mesh without tensor parallelism: every rank a data shard."""
    size, rank = world()
    return Mesh(size, 1, rank)


def is_hybrid(mesh: Mesh) -> bool:
    """True when the mesh carries a tensor-parallel "model" axis."""
    return mesh.mp > 1


def data_axis_size(mesh: Mesh) -> int:
    """Number of data-parallel shards."""
    return mesh.dp


def data_parallel_size(num_devices, model_parallel: int = 1) -> int:
    """The number of data shards for ``options.num_gpu`` and
    ``options.model_parallel``: ``world // mp`` (:func:`mesh_shape`)."""
    return mesh_shape(world()[0], num_devices, model_parallel)[0]


def shard_ids_of(devices_flat, process_index: int) -> list:
    """Positions along the data axis owned by ``process_index``: shard ``s``
    of the global batch belongs to the process hosting device ``s`` (only
    ``.process_index`` is consulted)."""
    return [s for s, d in enumerate(devices_flat) if d.process_index == process_index]


def local_shard_ids(mesh: Optional[Mesh] = None) -> list:
    """The data shards this process feeds: its data-axis coordinate, the
    shard of its whole TP row (the JAX package enumerates mesh rows, not
    devices).  Without tensor parallelism rank ``r`` holds shard ``r``."""
    return [(mesh or default_mesh()).data_index]


def local_batch_rows(array: np.ndarray, num_shards: int,
                     shard_ids: Sequence[int]) -> np.ndarray:
    """Rows of a ``[num_shards * per_shard, ...]`` global batch that this
    process feeds, concatenated in shard order."""
    per_shard = array.shape[0] // num_shards
    return np.concatenate([array[s * per_shard:(s + 1) * per_shard] for s in shard_ids])


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def all_gather_into(out: torch.Tensor, tensor: torch.Tensor, group) -> torch.Tensor:
    """``out`` [size * n, ...] filled with every rank's ``tensor`` [n, ...]
    of ``group``, in rank order."""
    with torch.no_grad():
        dist.all_gather_into_tensor(out, tensor.contiguous(), group=group)
    return out


def reduce_scatter_into(out: torch.Tensor, tensor: torch.Tensor, group) -> torch.Tensor:
    """``out`` [n, ...]: this rank's block of ``tensor`` [size * n, ...]
    summed over ``group``."""
    with torch.no_grad():
        dist.reduce_scatter_tensor(out, tensor.contiguous(), group=group)
    return out


def all_reduce_(tensors: Sequence[torch.Tensor], group=None) -> None:
    """Sum each of ``tensors`` over ``group`` (default: every rank) in
    place, with one all-reduce of their flattened concatenation."""
    tensors = list(tensors)
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, group=group)
    pieces = flat.split([t.numel() for t in tensors])
    torch._foreach_copy_(tensors, [piece.view_as(t) for piece, t in zip(pieces, tensors)])


def all_gather_rows(tensors: Sequence[torch.Tensor], group=None) -> List[np.ndarray]:
    """Each of ``tensors`` (leading axis: this rank's rows; the same shapes
    on every rank) with the rows of every rank of ``group`` (default: every
    rank) stacked in rank order, as host arrays of the same dtype; one
    all-gather for all of them."""
    size = dist.get_world_size(group)
    rows = tensors[0].shape[0]
    # nccl gathers on the card; gloo gathers only host tensors
    device = tensors[0].device if dist.get_backend(group) == "nccl" else torch.device("cpu")
    flat = torch.cat([t.reshape(rows, -1).to(device, torch.float64) for t in tensors], 1)
    parts = [torch.empty_like(flat) for _ in range(size)]
    dist.all_gather(parts, flat, group=group)
    pieces = torch.cat(parts).cpu().split([t[0].numel() for t in tensors], dim=1)
    return [piece.reshape(size * rows, *t.shape[1:]).to(t.dtype).numpy()
            for piece, t in zip(pieces, tensors)]


def barrier() -> None:
    """Wait for every rank (no-op in a world of one)."""
    if world()[0] > 1:
        dist.barrier()


# ---------------------------------------------------------------------------
# sharded parameters
# ---------------------------------------------------------------------------

def channel_sharded(shape: Sequence[int], model_parallel: int, min_shard_dim: int = 8) -> bool:
    """The JAX package's ``state_shardings`` rule on one JAX leaf's shape:
    >= 2 dims, and a last axis that splits evenly over ``model_parallel``
    into pieces of at least ``min_shard_dim``."""
    return (len(shape) >= 2 and shape[-1] % model_parallel == 0
            and shape[-1] // model_parallel >= min_shard_dim)


def state_shardings(model: nn.Module, model_parallel: int,
                    min_shard_dim: int = 8) -> Dict[str, Optional[int]]:
    """For each parameter of ``model``, the dimension it is sharded along
    over the "model" axis, or ``None`` where it stays replicated: JAX's
    rule (:func:`channel_sharded`) on the shape of the JAX leaf the
    parameter is carried from (``from_jax.jax_channel_axes``).  Buffers
    (BatchNorm statistics) stay replicated."""
    from ..from_jax import jax_channel_axes

    return {name: (dim if channel_sharded(shape, model_parallel, min_shard_dim) else None)
            for name, (shape, dim) in jax_channel_axes(model).items()}


def _is_sharded(tensor) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(tensor, DTensor)


def local(tensor: torch.Tensor) -> torch.Tensor:
    """This rank's piece of a sharded tensor (a view: writing it writes the
    shard), or the tensor itself."""
    return tensor.to_local() if _is_sharded(tensor) else tensor


def shard_spec(tensor) -> Optional[Tuple[int, object, int, int]]:
    """``(dim, group, index, count)`` of a tensor sharded along ``dim``
    over the ``count`` ranks of ``group``, this rank's piece being
    ``index``; ``None`` for a plain tensor."""
    if not _is_sharded(tensor):
        return None
    device_mesh = tensor.device_mesh
    return (tensor.placements[0].dim, device_mesh.get_group(), device_mesh.get_local_rank(),
            device_mesh.size())


def shard_like(full: torch.Tensor, like) -> torch.Tensor:
    """``full`` laid out as ``like`` (a sharded tensor of the same global
    shape): this rank's piece, cut locally; ``full`` itself when ``like``
    is plain."""
    spec = shard_spec(like)
    if spec is None:
        return full
    from torch.distributed.tensor import DTensor

    dim, _, index, count = spec
    piece = full.detach().to(like.device, like.dtype).chunk(count, dim)[index].contiguous()
    return DTensor.from_local(piece, like.device_mesh, like.placements, run_check=False)


def _gather_full(pieces: Sequence[torch.Tensor], dims: Sequence[int], group,
                 count: int) -> List[torch.Tensor]:
    """Every rank's ``pieces`` joined along their ``dims``, with one
    all-gather of their flattened concatenation."""
    flat = torch.cat([p.reshape(-1) for p in pieces])
    out = all_gather_into(flat.new_empty(count * flat.numel()), flat, group)
    ranks = out.view(count, -1).split([p.numel() for p in pieces], dim=1)
    return [torch.cat([r.view(p.shape) for r in rows.unbind(0)], dim=d)
            for rows, p, d in zip(ranks, pieces, dims)]


def full_tensors(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Each of ``tensors`` whole: a sharded one gathered over its TP row,
    all of them of one dtype in one collective (every rank of the row must
    call with tensors of the same layouts), a plain one as it is."""
    out = list(tensors)
    by_dtype: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(out):
        if _is_sharded(t):
            by_dtype.setdefault(t.dtype, []).append(i)
    for indices in by_dtype.values():
        specs = [shard_spec(out[i]) for i in indices]
        fulls = _gather_full([out[i].to_local().detach() for i in indices],
                             [spec[0] for spec in specs], specs[0][1], specs[0][3])
        for i, full in zip(indices, fulls):
            out[i] = full
    return out


def full_tensor(tensor: torch.Tensor) -> torch.Tensor:
    """The whole of a sharded tensor (:func:`full_tensors`), or the tensor."""
    return full_tensors([tensor])[0]


class _GatherShards(torch.autograd.Function):
    """Forward: the full tensors of sharded parameters' local pieces, one
    all-gather over the TP row.  Backward: each full gradient summed over
    the row and cut to this rank's piece, one reduce-scatter."""

    @staticmethod
    def forward(ctx, group, count, dims, *pieces):
        ctx.group, ctx.count, ctx.dims = group, count, dims
        ctx.shapes = [p.shape for p in pieces]
        return tuple(_gather_full(pieces, dims, group, count))

    @staticmethod
    def backward(ctx, *grads):
        device = next(g.device for g in grads if g is not None)
        # a whole parameter that took no gradient sends zeros
        chunks = [(g if g is not None else torch.zeros(
            s[:d] + (s[d] * ctx.count,) + s[d + 1:], device=device)).chunk(ctx.count, d)
            for g, s, d in zip(grads, ctx.shapes, ctx.dims)]
        flat = torch.cat([c[r].reshape(-1) for r in range(ctx.count) for c in chunks])
        mine = reduce_scatter_into(flat.new_empty(flat.numel() // ctx.count), flat, ctx.group)
        pieces = mine.split([s.numel() for s in ctx.shapes])
        return (None, None, None, *(p.view(s) for p, s in zip(pieces, ctx.shapes)))


@contextmanager
def gathered_parameters(module: nn.Module):
    """Within it, each sharded parameter of ``module`` reads as its full
    tensor, gathered over the TP row with autograd back to the shard; a
    module without sharded parameters is left as it is (no collective)."""
    found = [(m, name, p) for m in module.modules()
             for name, p in m._parameters.items() if p is not None and _is_sharded(p)]
    if not found:
        yield
        return
    _, group, _, count = shard_spec(found[0][2])
    fulls = _GatherShards.apply(group, count, tuple(shard_spec(p)[0] for _, _, p in found),
                                *(p.to_local() for _, _, p in found))
    for (m, name, _), full in zip(found, fulls):
        m._parameters[name] = full
    try:
        yield
    finally:
        for m, name, p in found:
            m._parameters[name] = p


def _enter_gathered(module, args):
    context = gathered_parameters(module)
    context.__enter__()
    module._tp_gathered = context


def _exit_gathered(module, args, output):
    context = module.__dict__.pop("_tp_gathered", None)
    if context is not None:
        context.__exit__(None, None, None)


def _load_sharded(module, state_dict, prefix, *args):
    """A full tensor loaded into a sharded parameter becomes this rank's
    piece of it (checkpoints and transplanted weights are whole)."""
    for name, p in module.named_parameters():
        key = prefix + name
        if _is_sharded(p) and key in state_dict and not _is_sharded(state_dict[key]):
            state_dict[key] = shard_like(state_dict[key], p)


def shard_parameters(model: nn.Module, mesh: Mesh, min_shard_dim: int = 8) -> Dict[str, int]:
    """Lay ``model``'s parameters out over ``mesh``'s "model" axis by
    :func:`state_shardings` (each sharded one a ``DTensor`` ``Shard(d)``
    holding this rank's piece), in place, and hook the model so that its
    forward reads them whole (:func:`gathered_parameters`) and its
    ``load_state_dict`` takes whole tensors.  Returns the sharded
    parameters' dimensions.  Build the optimizer after this."""
    from torch.distributed.tensor import DTensor, Shard

    dims = {n: d for n, d in state_shardings(model, mesh.mp, min_shard_dim).items()
            if d is not None}
    for mod_name, module in model.named_modules():
        for p_name, p in list(module._parameters.items()):
            dim = dims.get(f"{mod_name}.{p_name}" if mod_name else p_name)
            if dim is None:
                continue
            piece = p.detach().chunk(mesh.mp, dim)[mesh.model_index].contiguous()
            module._parameters[p_name] = nn.Parameter(
                DTensor.from_local(piece, mesh.model_mesh, [Shard(dim)], run_check=False),
                requires_grad=p.requires_grad)
    model.register_forward_pre_hook(_enter_gathered)
    model.register_forward_hook(_exit_gathered, always_call=True)
    model._register_load_state_dict_pre_hook(_load_sharded, with_module=True)
    return dims


def reshard_optimizer_state(optimizer: torch.optim.Optimizer) -> None:
    """After ``optimizer.load_state_dict`` of whole tensors: each state
    tensor of a sharded parameter's shape becomes this rank's piece."""
    for p, slots in optimizer.state.items():
        if not _is_sharded(p):
            continue
        for key, value in slots.items():
            if torch.is_tensor(value) and not _is_sharded(value) and value.shape == p.shape:
                slots[key] = shard_like(value, p)


def unsharded_copy(model: nn.Module) -> nn.Module:
    """A copy of ``model`` whose parameters are whole plain tensors (one
    gather; every rank of the TP row must call), for inference without
    collectives; ``model`` itself when nothing is sharded.  The copy shares
    the sync-BN process groups of ``model``'s modules."""
    import copy

    found = [(m, name, p) for m in model.modules()
             for name, p in m._parameters.items() if p is not None and _is_sharded(p)]
    if not found:
        return model
    fulls = full_tensors([p.detach() for _, _, p in found])
    for (m, name, p), full in zip(found, fulls):
        m._parameters[name] = nn.Parameter(full, requires_grad=p.requires_grad)
    groups = {id(g): g for g in (getattr(m, "process_group", None) for m in model.modules())
              if g is not None}
    try:
        return copy.deepcopy(model, groups)
    finally:
        for m, name, p in found:
            m._parameters[name] = p
