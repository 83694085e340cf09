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

**Tensor parallelism** (:func:`shard_parameters`), as JAX's hybrid mesh
lets GSPMD partition every product over the model axis.  The ranks of a
row hold the same data shard, and each layer pair below computes 1/mp of
its channels on each rank, in Megatron's terms (:func:`copy_to_row` is
``f``, identity forward and a sum over the row backward;
:func:`reduce_from_row` is ``g``, a sum over the row forward and identity
backward):

* a DenseNet ``Bottleneck`` (dense and coo families): ``f``, conv1
  column-parallel (``expand / mp`` output channels), norm2 and relu2 on
  those channels (their statistics are per channel, so no collective),
  conv2 row-parallel over them, ``g``, then conv2's bias and the dropout;
* a ``MultiHeadAttention``: ``f``, the q/k/v rows of ``heads / mp`` whole
  heads, ``out_proj`` row-parallel, ``g``, then its bias;
* an ``EncoderLayer``'s feed-forward: ``f``, ``linear1`` column-parallel,
  GELU and dropout on its channels (the mask drawn whole and cut, so the
  row draws what one process draws), ``linear2`` row-parallel, ``g``.

Everything outside those pairs (norm1 and relu1 on the whole input, the
LayerNorms, transitions, stems, the feature and combined embeddings, the
heads, position vectors, DecoderLayer's feed-forward and every other
family's embedder) computes whole on every rank: a sharded weight there is
gathered inside the forward (:func:`whole`: the piece in zeros of the
whole, summed over the row; the backward keeps this rank's piece of the
gradient).  The collectives are functional all-reduces, autograd-aware, so
``torch.compile`` traces them.

**The layout** (:func:`tensor_layout`).  Which parameters are sharded is
JAX's ``state_shardings`` rule (:func:`state_shardings`: >= 2 dims and a
last, output-channel axis that splits over mp into pieces of at least
``min_shard_dim``), plus the 1-D tensors of the norms and PReLUs between a
column- and a row-parallel layer (norm2's and relu2's weights, biases and
running statistics), which are sharded with their channels.  Which *dim*
holds a rank's piece follows the compute: output channels (dim 0) of a
column-parallel or whole-computed conv or linear, input channels (dim 1)
of a row-parallel one, whole heads of the packed ``in_proj_*`` (each of
its q, k and v blocks cut alike; JAX cuts ``head_dim`` instead), the last
dim of position and classifier vectors.  Each is a ``DTensor`` over the
"model" sub-mesh (``Shard(d)``, ``_StridedShard(0, 3)`` for ``in_proj``),
and the optimizers make their moments from the parameter, so they follow
it.  Every other tensor stays whole and replicated; a replicated one that
a partitioned layer reads in pieces (conv1's and linear1's biases, and at
narrow widths a weight JAX keeps whole) is cut in the forward
(:func:`piece`), and its gradient comes back whole, zero outside the
piece and scaled by mp.

**Gradients.**  The loss carries ``1 / world``.  A replicated gradient,
the metrics and the replicated BatchNorm statistics of an unsynced run are
summed over every rank: each row computes its data shard's whole gradient
on each of its mp ranks (``f`` sums the input gradients of the partitioned
layers), so the world sum with ``1 / world`` is the mean over the data
shards, and the replicas of a row come out equal bit for bit even where a
kernel on the card sums in no fixed order.  A sharded gradient is computed
once a row, so it is scaled by mp and summed over the "data" group, as are
the sharded running statistics (scaled by ``1 / dp``).  ``global_norm``
counts each sharded gradient once (local squares summed over the "model"
group).  Sync-BN, the validation sums and the gathered predictions run
over the "data" group.

**Collectives with ``gloo`` on CUDA tensors** (every rank on one card):
the tensor-parallel step needs the functional ``all_reduce`` (inside the
forward and backward) and, for checkpoints, the eager
``all_gather_into_tensor``; ``gloo`` takes both on CUDA tensors on an
H100 with torch 2.11 (PERF.md), where its functional all-gather crashes,
so the forward's gathers are all-reduces too (:func:`whole`).

**Checkpoints** stay layout-independent: :func:`full_tensor` gathers a
sharded tensor (a collective every rank of the row joins), and a full
tensor loaded into a sharded parameter, buffer or moment is cut to this
rank's piece (:func:`shard_like`), so a TP run resumes and evaluates on
any layout.
"""

from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass
from datetime import timedelta
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol
from torch import nn
from torch.distributed.tensor import DTensor, Shard

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


def group_backend() -> Optional[str]:
    """The default process group's backend ("nccl", "gloo"); ``None``
    without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_backend()
    return None


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
    # nccl gathers on this process's card; gloo gathers only host tensors
    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend(group) == "nccl" else torch.device("cpu"))
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


# the default group and the gloo group over its ranks that host-side checks
# beside an nccl world run on (the default group held, so a later one is
# never taken for it)
_HOST_GROUP: List[object] = []


def _host_group():
    """A ``gloo`` group of every rank (the default group itself when that is
    gloo), made at the first call in a default group, which every rank
    makes at the same point of the program, as ``new_group`` asks."""
    if dist.get_backend() == "gloo":
        return dist.group.WORLD
    if not _HOST_GROUP or _HOST_GROUP[0] is not dist.group.WORLD:
        _HOST_GROUP[:] = [dist.group.WORLD,
                          dist.new_group(backend="gloo", timeout=GROUP_TIMEOUT)]
    return _HOST_GROUP[1]


def assert_same_on_every_rank(value: str, what: str) -> None:
    """Raise on every rank unless every rank of the default group passed an
    equal ``value``: one all-reduce of a digest of it over a ``gloo`` group
    on the host (a round trip of the ranks' hosts, no device work).  No-op
    in a world of one."""
    size, rank = world()
    if size == 1:
        return
    digest = int.from_bytes(hashlib.sha256(value.encode()).digest()[:7], "big")
    seen = torch.tensor([digest, -digest], dtype=torch.int64)
    dist.all_reduce(seen, op=dist.ReduceOp.MAX, group=_host_group())
    if int(seen[0]) != digest or -int(seen[1]) != digest:
        raise RuntimeError(
            f"{what} differs between the ranks (rank {rank}: {value}); every rank must "
            "make the same call, or the collectives of one meet those of another")


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
    return isinstance(tensor, DTensor)


def local(tensor: torch.Tensor) -> torch.Tensor:
    """This rank's piece of a sharded tensor (a view: writing it writes the
    shard), or the tensor itself."""
    return tensor.to_local() if _is_sharded(tensor) else tensor


class ShardSpec(NamedTuple):
    """A tensor held in pieces over the ``count`` ranks of ``group``: along
    ``dim``, which packs ``blocks`` equal blocks (3 for the q/k/v of an
    ``in_proj``), each cut in ``count`` and this rank holding piece
    ``index`` of every block."""

    dim: int
    group: object
    index: int
    count: int
    blocks: int


def shard_spec(tensor) -> Optional[ShardSpec]:
    """The :class:`ShardSpec` of a sharded tensor; ``None`` for a plain one."""
    if not _is_sharded(tensor):
        return None
    device_mesh, placement = tensor.device_mesh, tensor.placements[0]
    return ShardSpec(placement.dim, device_mesh.get_group(), device_mesh.get_local_rank(),
                     device_mesh.size(), getattr(placement, "split_factor", 1))


def cut_piece(full: torch.Tensor, dim: int, blocks: int, index: int,
              count: int) -> torch.Tensor:
    """Piece ``index`` of ``count`` of ``full`` along ``dim``: of each of
    its ``blocks`` blocks, that piece, joined."""
    return torch.cat([block.chunk(count, dim)[index] for block in full.chunk(blocks, dim)],
                     dim)


def join_pieces(pieces: Sequence[torch.Tensor], dim: int, blocks: int) -> torch.Tensor:
    """The whole tensor of every rank's piece, in rank order
    (:func:`cut_piece`'s inverse)."""
    parts = [p.chunk(blocks, dim) for p in pieces]
    return torch.cat([part[b] for b in range(blocks) for part in parts], dim)


def _placement(dim: int, blocks: int):
    if blocks == 1:
        return Shard(dim)
    from torch.distributed.tensor.placement_types import _StridedShard

    return _StridedShard(dim, split_factor=blocks)


def shard_like(full: torch.Tensor, like) -> torch.Tensor:
    """``full`` laid out as ``like`` (a sharded tensor of the same global
    shape): this rank's piece, cut locally; ``full`` itself when ``like``
    is plain."""
    spec = shard_spec(like)
    if spec is None:
        return full
    piece = cut_piece(full.detach().to(like.device, like.dtype), spec.dim, spec.blocks,
                      spec.index, spec.count).contiguous()
    return DTensor.from_local(piece, like.device_mesh, like.placements, run_check=False)


def _gather_full(pieces: Sequence[torch.Tensor], specs: Sequence[ShardSpec]
                 ) -> List[torch.Tensor]:
    """Every rank's ``pieces`` joined by their ``specs``, with one
    all-gather of their flattened concatenation."""
    count = specs[0].count
    flat = torch.cat([p.reshape(-1) for p in pieces])
    out = all_gather_into(flat.new_empty(count * flat.numel()), flat, specs[0].group)
    ranks = out.view(count, -1).split([p.numel() for p in pieces], dim=1)
    return [join_pieces([r.view(p.shape) for r in rows.unbind(0)], spec.dim, spec.blocks)
            for rows, p, spec in zip(ranks, pieces, specs)]


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
        fulls = _gather_full([out[i].to_local().detach() for i in indices],
                             [shard_spec(out[i]) for i in indices])
        for i, full in zip(indices, fulls):
            out[i] = full
    return out


def full_tensor(tensor: torch.Tensor) -> torch.Tensor:
    """The whole of a sharded tensor (:func:`full_tensors`), or the tensor."""
    return full_tensors([tensor])[0]


# ---------------------------------------------------------------------------
# the partitioned layers' collectives (functional: torch.compile traces them)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Row:
    """The TP row a partitioned layer computes over: its process group, this
    rank's place in it and its size."""

    group: object
    index: int
    count: int


def sum_over(tensor: torch.Tensor, group) -> torch.Tensor:
    """``tensor`` summed over ``group`` by a functional collective, which
    ``torch.compile`` traces into its graph (``dist.all_reduce`` would
    break it)."""
    return funcol.wait_tensor(funcol.all_reduce(tensor.contiguous(), "sum", group))


class _CopyToRow(torch.autograd.Function):
    """Megatron's ``f``: the identity forward; the backward sums the
    gradient over the row (each rank's column-parallel layer gave the input
    its channels' part of it)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return sum_over(grad, ctx.group), None


class _ReduceFromRow(torch.autograd.Function):
    """Megatron's ``g``: a row-parallel layer's partial products summed
    over the row; the backward passes the gradient on as it is."""

    @staticmethod
    def forward(ctx, x, group):
        return sum_over(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_row(x: torch.Tensor, row: Row) -> torch.Tensor:
    """``x`` entering a column-parallel layer of ``row`` (``f``)."""
    return _CopyToRow.apply(x, row.group)


def reduce_from_row(x: torch.Tensor, row: Row) -> torch.Tensor:
    """A row-parallel layer's partial output summed over ``row`` (``g``)."""
    return _ReduceFromRow.apply(x, row.group)


class _GatherChannels(torch.autograd.Function):
    """The whole of a sharded tensor from this rank's piece: the piece in
    place in zeros of the whole, summed over its row (the functional
    all-gather crashes ``gloo`` on CUDA tensors in torch 2.11, its
    all-reduce does not; the weights gathered so are small).  The backward
    keeps this rank's piece of the gradient (the row's ranks compute alike
    with the whole, so each holds the whole gradient)."""

    @staticmethod
    def forward(ctx, piece, dim, blocks, group, index, count):
        ctx.cut = dim, blocks, index, count
        zero = torch.zeros_like(piece)
        return sum_over(join_pieces([piece if r == index else zero for r in range(count)],
                                    dim, blocks), group)

    @staticmethod
    def backward(ctx, grad):
        return cut_piece(grad, *ctx.cut).contiguous(), None, None, None, None, None


class _CutReplicated(torch.autograd.Function):
    """This rank's piece of a replicated tensor; the gradient comes back
    whole, zero outside the piece and scaled by the row's size, so that
    the sum over every rank (each row adds each piece once) with the
    loss's ``1 / world`` is the mean over the data shards."""

    @staticmethod
    def forward(ctx, whole, dim, blocks, index, count):
        ctx.cut = dim, blocks, index, count
        return cut_piece(whole, dim, blocks, index, count)

    @staticmethod
    def backward(ctx, grad):
        dim, blocks, index, count = ctx.cut
        zero = torch.zeros_like(grad)
        pieces = [grad * count if r == index else zero for r in range(count)]
        return join_pieces(pieces, dim, blocks), None, None, None, None


def whole(tensor: torch.Tensor) -> torch.Tensor:
    """The whole of a sharded parameter, gathered over its row inside the
    forward (:class:`_GatherChannels`), for a layer that computes whole; a
    plain tensor as it is."""
    if not _is_sharded(tensor):
        return tensor
    spec = shard_spec(tensor)
    return _GatherChannels.apply(tensor.to_local(), spec.dim, spec.blocks, spec.group,
                                 spec.index, spec.count)


def piece(tensor: torch.Tensor, row: Row, dim: int, blocks: int = 1) -> torch.Tensor:
    """This rank's piece, along ``dim`` (of each of ``blocks`` blocks), of a
    tensor a partitioned layer of ``row`` reads: a sharded one's local
    piece, laid out so by :func:`tensor_layout`, or a cut of a replicated
    one."""
    if _is_sharded(tensor):
        return tensor.to_local()
    return _CutReplicated.apply(tensor, dim, blocks, row.index, row.count)


# ---------------------------------------------------------------------------
# the layout
# ---------------------------------------------------------------------------

def tensor_layout(model: nn.Module, model_parallel: int, min_shard_dim: int = 8
                  ) -> Dict[str, Tuple[int, int]]:
    """``name -> (dim, blocks)`` of every parameter and buffer of ``model``
    held in pieces over ``model_parallel`` ranks: the parameters
    :func:`state_shardings` shards, each along the dimension its layer
    computes with (a partitioned layer's ``tensor_parallel_pieces``), and
    the norms' and PReLUs' tensors between a column- and a row-parallel
    layer."""
    from ..from_jax import jax_leaf_splits
    from ..ops.masked import MaskedBatchNorm, PReLU

    splits = jax_leaf_splits(model)
    layout = {name: (dim, splits[name])
              for name, dim in state_shardings(model, model_parallel, min_shard_dim).items()
              if dim is not None}
    for prefix, module in partitioned_modules(model, model_parallel):
        for name, cut in module.tensor_parallel_pieces(model_parallel).items():
            full = f"{prefix}.{name}" if prefix else name
            owner = model.get_submodule(full.rpartition(".")[0])
            if full in layout or isinstance(owner, (MaskedBatchNorm, PReLU)):
                layout[full] = cut
    return layout


def partitioned_modules(model: nn.Module, model_parallel: int):
    """``(name, module)`` of each layer of ``model`` that partitions its
    compute over ``model_parallel`` ranks: one whose
    ``tensor_parallel_pieces(mp)`` names the tensors it reads in pieces
    (``None`` where its widths do not split)."""
    return [(name, module) for name, module in model.named_modules()
            if hasattr(module, "tensor_parallel_pieces")
            and module.tensor_parallel_pieces(model_parallel) is not None]


def _load_sharded(module, state_dict, prefix, *args):
    """A full tensor loaded into a sharded parameter or buffer becomes this
    rank's piece of it (checkpoints and transplanted weights are whole)."""
    for name, t in (*module.named_parameters(), *module.named_buffers()):
        key = prefix + name
        if _is_sharded(t) and key in state_dict and not _is_sharded(state_dict[key]):
            state_dict[key] = shard_like(state_dict[key], t)


def shard_parameters(model: nn.Module, mesh: Mesh, min_shard_dim: int = 8
                     ) -> Dict[str, Tuple[int, int]]:
    """Lay ``model``'s parameters and buffers out over ``mesh``'s "model"
    axis by :func:`tensor_layout` (each sharded one a ``DTensor`` holding
    this rank's piece), in place; give each partitioned layer its
    :class:`Row`, and make ``load_state_dict`` take whole tensors.  Returns
    the layout.  Build the optimizer after this."""
    layout = tensor_layout(model, mesh.mp, min_shard_dim)
    row = Row(mesh.model_mesh.get_group(), mesh.model_index, mesh.mp)
    for mod_name, module in model.named_modules():
        for table in (module._parameters, module._buffers):
            for name, t in list(table.items()):
                cut = layout.get(f"{mod_name}.{name}" if mod_name else name)
                if cut is None:
                    continue
                dim, blocks = cut
                local_piece = cut_piece(t.detach(), dim, blocks, mesh.model_index,
                                        mesh.mp).contiguous()
                sharded = DTensor.from_local(local_piece, mesh.model_mesh,
                                             [_placement(dim, blocks)], run_check=False)
                table[name] = (nn.Parameter(sharded, requires_grad=t.requires_grad)
                               if table is module._parameters else sharded)
    for _, module in partitioned_modules(model, mesh.mp):
        module.tp = row
    model._register_load_state_dict_pre_hook(_load_sharded, with_module=True)
    return layout


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
    """A copy of ``model`` whose parameters and buffers are whole plain
    tensors and whose layers compute whole (one gather; every rank of the
    TP row must call), for inference without collectives; ``model`` itself
    when nothing is sharded.  The copy shares the sync-BN process groups of
    ``model``'s modules."""
    import copy

    found = [(table, name, t) for m in model.modules()
             for table in (m._parameters, m._buffers)
             for name, t in table.items() if t is not None and _is_sharded(t)]
    if not found:
        return model
    fulls = full_tensors([t.detach() for _, _, t in found])
    for (table, name, t), full in zip(found, fulls):
        table[name] = (nn.Parameter(full, requires_grad=t.requires_grad)
                       if isinstance(t, nn.Parameter) else full)
    rows = [(m, m.tp) for m in model.modules() if getattr(m, "tp", None) is not None]
    groups = {id(g): g for g in (getattr(m, "process_group", None) for m in model.modules())
              if g is not None}
    try:
        for m, _ in rows:
            m.tp = None
        return copy.deepcopy(model, groups)
    finally:
        for (table, name, t) in found:
            table[name] = t
        for m, tp in rows:
            m.tp = tp
