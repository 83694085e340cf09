"""CUDA graphs of the port's steps: the counterpart of ``jax.jit``'s one
program a batch shape, and of ``lax.scan`` over K train steps.

The JAX package runs each predict, eval and train call as one compiled
program, and ``steps_per_dispatch`` K puts K optimizer steps into one
(``dune_transformercvn_tpu/train/step.py``).  On the card the port records
a step's kernels once into a ``torch.cuda.CUDAGraph`` and replays them,
one launch of the graph a call, instead of thousands of launches from the
host.  :class:`StepGraphs` keeps one graph for each input shape:

* the first call of a shape copies its inputs into static buffers, warms
  the body up on a side stream (lazy library handles, the compiled
  forward's first call) and captures it; every later call copies its
  inputs into the same buffers and replays;
* the graphs of one step share one private memory pool, and past
  ``shapes`` graphs a new shape raises, as ``utils/compile.py``'s
  recompile limit does;
* a failure inside the capture raises: no step asked for a graph runs
  uncaptured on the card;
* the launch counters of kernels K1 and K2 (``densify_images_cuda``,
  ``scatter_patches_cuda``; a graph's ``launches``) and of the int8
  convolutions' ``_int_mm`` route (``ops.quant.conv_int32_cuda``; its
  ``route_launches``) tick during the capture, which launches nothing;
  the capture takes its ticks back and every replay adds them again, so
  the counters count the real launches.

:class:`EventGraph` serves one event the way the JAX package serves it,
one dispatch of one rung's compiled program (``native/pjrt_loader.cc``'s
``Execute``): it captures a one-event program of ``export.py`` or
``aoti.py`` (``(pixels [1+P, C, H, W] float32, num_prongs 0-d int32) ->
outputs``) once, with a memory pool of its own, and every call copies the
event into the static inputs and replays it.

A body draws its random numbers from generator states registered with
the graph (:func:`generator_states`), which the caller seeds before each
replay; what a replay reads from the host is what the caller copies in.

**In a process group** (one process a card, ``nccl``; ``lockstep``) a body
may hold collectives: the train step's all-reduces, sync-BN's, the tensor-
parallel row's.  A capture records them on nccl's stream, forked from and
joined to the capturing one, and every replay runs them; a rank's replay
waits on the card for the same collective of the others'.  So:

* the warm-up runs every collective of the body on every rank before any
  rank captures: the first collective of each group creates its nccl
  communicator, which a capture cannot, and the same sizes set up nccl's
  connections;
* every rank must capture and replay the same graphs in the same order.
  The step functions guarantee it by construction: every rank calls them
  in the same order on batches of the same shape (the batchers lay out
  every rank's shard of a global batch in the shape the global index list
  decides, bucketed or static), and the ranks of a tensor-
  parallel row on the same batch.  A call checks it too: the ranks compare
  the call's shape key over a ``gloo`` group on the host
  (``parallel.assert_same_on_every_rank``, one host round trip a call) and
  raise together where one differs, rather than hang with the collectives
  of one graph waiting on another's;
* the capture is ``thread_local``: the calls that would break a global
  capture come from other threads (the batcher's pinning of host memory,
  ProcessGroupNCCL's watchdog querying the events of earlier collectives),
  while nccl's own work (event records and waits between the streams, its
  kernels) runs on the capturing thread and is legal in a capture.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch

from ..ops.coo_stem import scatter_patches_cuda
from ..ops.densify import densify_images_cuda
from ..ops.quant import conv_int32_cuda
from ..parallel.mesh import assert_same_on_every_rank

# the wrappers whose ``launches`` count a kernel's launches
LAUNCH_COUNTERS = (densify_images_cuda, scatter_patches_cuda)
# and the int8 convolutions' route, counted the same way
ROUTE_COUNTERS = (conv_int32_cuda,)


def shape_key(*trees: Dict[str, torch.Tensor]):
    """What decides a graph: every input's name, shape and dtype."""
    return tuple((i, name, tuple(t.shape), t.dtype)
                 for i, tree in enumerate(trees) for name, t in sorted(tree.items()))


def generator_states(device, count: int) -> List[torch.Generator]:
    """``count`` fresh states of ``device``'s default CUDA generator, one
    for each step a graph holds; ``manual_seed`` on one before a replay
    gives that step the draws an eager step seeded alike makes."""
    default = torch.cuda.default_generators[torch.device(device).index or 0]
    return [default.clone_state() for _ in range(count)]


class Captured:
    """One captured graph: its static ``inputs`` (name -> tensor, per
    tree), ``outputs``, the generator ``states`` it reads, and the
    launches a replay makes of K1 and K2 (``launches``) and of the int8
    route (``route_launches``)."""

    def __init__(self, graph, inputs, outputs, states, launches, route_launches):
        self.graph, self.inputs, self.outputs = graph, inputs, outputs
        self.states, self.launches = states, launches
        self.route_launches = route_launches

    def load(self, *trees: Dict[str, torch.Tensor]) -> None:
        """Copy a call's tensors into the static inputs (from pinned host
        memory without waiting; stream order keeps them behind the last
        replay's reads)."""
        for static, tree in zip(self.inputs, trees):
            for name, value in tree.items():
                static[name].copy_(value, non_blocking=True)

    def replay(self):
        self.graph.replay()
        for counter, count in zip(LAUNCH_COUNTERS + ROUTE_COUNTERS,
                                  self.launches + self.route_launches):
            counter.launches += count
        return self.outputs


class StepGraphs:
    """The graphs of one step function, one for each input shape, at most
    ``shapes`` of them, in one memory pool.

    ``body(*inputs, states)`` is the step: it reads the static input trees
    and returns its outputs (tensors the graph writes at each replay).
    ``states_per_graph`` generator states are registered with each graph
    and passed to the body.  ``around_warmup``, when given, is a context
    manager entered around the warm-up, e.g. one that puts back the state
    the warm-up steps changed.  ``lockstep``: every rank of the default
    process group makes the same calls (the body holds collectives); each
    call's shape key is checked across the ranks."""

    def __init__(self, body: Callable, name: str, shapes: int = 1,
                 states_per_graph: int = 0, around_warmup: Optional[Callable] = None,
                 lockstep: bool = False):
        self.body, self.name, self.shapes = body, name, int(shapes)
        self.states_per_graph = states_per_graph
        self.around_warmup = around_warmup
        self.lockstep = lockstep
        self.graphs: Dict[tuple, Captured] = {}
        self.pool = None

    def get(self, device, *trees: Dict[str, torch.Tensor]) -> Captured:
        """The graph of these inputs' shape on ``device``, captured at its
        first call (and loaded with them then)."""
        key = shape_key(*trees)
        if self.lockstep:
            assert_same_on_every_rank(repr(key), f"{self.name}'s batch shape")
        captured = self.graphs.get(key)
        if captured is None:
            if len(self.graphs) >= self.shapes:
                raise RuntimeError(
                    f"{self.name}: a batch shape past the {self.shapes} graph(s) this "
                    f"step was made for ({len(self.graphs)} captured); a graph step "
                    "does not run uncaptured")
            captured = self.graphs[key] = self._capture(torch.device(device), trees)
        return captured

    def _capture(self, device, trees: Sequence[Dict[str, torch.Tensor]]) -> Captured:
        if device.type != "cuda":
            raise ValueError(f"{self.name}: CUDA graphs need CUDA tensors, got {device}")
        inputs = tuple({name: torch.empty_like(t, device=device) for name, t in tree.items()}
                       for tree in trees)
        for static, tree in zip(inputs, trees):
            for name, value in tree.items():
                static[name].copy_(value)
        states = generator_states(device, self.states_per_graph)
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            if self.around_warmup is None:
                self.body(*inputs, states)
            else:
                with self.around_warmup():
                    self.body(*inputs, states)
        torch.cuda.current_stream(device).wait_stream(side)
        # the warm-up's blocks back to the card, for the graph's pool
        torch.cuda.empty_cache()
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        for state in states:
            graph.register_generator_state(state)
        counters = LAUNCH_COUNTERS + ROUTE_COUNTERS
        before = [c.launches for c in counters]
        try:
            # thread_local: the batcher's threads may pin host memory and
            # nccl's watchdog query events meanwhile (module docstring)
            with torch.cuda.graph(graph, pool=self.pool, capture_error_mode="thread_local"):
                outputs = self.body(*inputs, states)
        except Exception as error:
            raise RuntimeError(f"{self.name}: CUDA graph capture failed: {error}") from error
        launches = [c.launches - b for c, b in zip(counters, before)]
        for counter, count in zip(counters, before):
            counter.launches = count
        kernels = len(LAUNCH_COUNTERS)
        return Captured(graph, inputs, outputs, states, launches[:kernels],
                        launches[kernels:])


class EventGraph:
    """One rung's one-event program ``fn(pixels, num_prongs) -> outputs``
    as one CUDA graph.

    The first call on the card allocates the static inputs (the pixel maps'
    ``[1+P, C, H, W]`` float32 buffer and the 0-d int32 ``num_prongs``) and
    copies the event into them, warms ``fn`` up on a side stream (lazy
    cuBLAS/cuDNN handles, a package's first-call loads) and captures it
    into a graph with a memory pool of its own; every call copies its
    event in and replays, and returns copies of the graph's static
    outputs (the next replay overwrites them).  A failure inside the
    capture raises; an event of another shape raises (one graph a rung).
    On the CPU ``fn`` runs uncaptured."""

    def __init__(self, fn: Callable, name: str = "one-event graph"):
        self.fn = fn
        self.graphs = StepGraphs(lambda event, states: tuple(
            fn(event["pixels"], event["num_prongs"])), name)

    def __call__(self, pixels: torch.Tensor, num_prongs: torch.Tensor):
        if pixels.device.type != "cuda":
            return list(self.fn(pixels, num_prongs))
        event = {"pixels": pixels, "num_prongs": num_prongs}
        captured = self.graphs.get(pixels.device, event)
        captured.load(event)
        return [out.clone() for out in captured.replay()]
