"""Batched inference: the serving path.

Port of ``make_predict_step`` (``dune_transformercvn_tpu/train/step.py``) and
``Trainer.predict_split`` (``dune_transformercvn_tpu/train/loop.py``).
:func:`predict_split` serves on one device, or on every rank of a
data-parallel process group, each rank assembling and predicting its data
shard of every batch and the shards' rows gathered in order (with tensor
parallelism over the "data" group, so a TP row's shard comes once).
Batches come from the port's :class:`.data.Batcher`.
"""

from __future__ import annotations

import itertools
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from .data import Batcher, split_current_targets
from .ops import quant
from .ops.fold import folded_copy
from .parallel import Mesh, all_gather_rows, default_mesh, local_shard_ids, unsharded_copy
from .utils.compile import compile_step
from .utils.graphs import StepGraphs


def to_device(arrays: Mapping[str, np.ndarray], device,
              non_blocking: bool = False) -> Dict[str, torch.Tensor]:
    """numpy arrays or host tensors (a batch, or the norm statistics) ->
    tensors on ``device``.  ``non_blocking`` copies from :func:`pinned`
    tensors do not wait for the device."""
    return {k: (v if torch.is_tensor(v) else torch.as_tensor(np.asarray(v))).to(
        device, non_blocking=non_blocking) for k, v in arrays.items()}


def pinned(arrays: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """A batch's numpy arrays -> tensors in page-locked host memory, from
    which ``to_device(..., non_blocking=True)`` queues the copy to the card
    without synchronising the stream (a copy from pageable memory waits
    for the work queued before it).  Needs CUDA."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
            for k, v in arrays.items()}


def make_predict_step(model, compile: bool = False, shapes: int = 1,
                      graph: bool = False) -> Callable[..., Tuple[torch.Tensor, torch.Tensor]]:
    """Inference step: ``(batch, norm) -> (event_probs [B, Kev], prong_probs
    [B, P, Kpr])``, softmax over the logits.  Puts ``model`` in eval mode.

    In split mode the event scores are the 4-way current head's softmax (the
    generation head is a training-time auxiliary).  ``compile``: the forward
    through the softmax is one Inductor graph a batch shape
    (:func:`.utils.compile.compile_step`, for up to ``shapes`` shapes).
    ``graph``: on the card, one CUDA graph a batch shape
    (:class:`.utils.graphs.StepGraphs`, up to ``shapes``): the call copies
    the batch (pinned host or device tensors) and ``norm`` into the graph's
    buffers and replays it, and the probabilities it returns are the
    graph's output buffers, which the next call overwrites; on the CPU the
    same forward runs without a capture.  The graphs read ``model``'s
    parameters where they are, so updates made in place (training,
    ``load_state_dict``) reach the next replay.

    Inside an int8 context (:func:`.ops.quant.quantized_convs`) the step is
    the quantized forward, eager, compiled (Dynamo traces the context's
    interception, as ``jax.jit`` traces JAX's) or captured (the ``_int_mm``
    route's GEMMs in the graph).  A compiled or graph step serves the
    context it was made in, and raises in any other: its graphs were
    traced or captured with that context's convolutions.
    """
    num_event = model.cfg.num_event_classes
    model.eval()

    def forward(batch, norm):
        event_logits, prong_logits = model(batch, norm)
        return (
            torch.softmax(event_logits[:, :num_event], dim=-1),
            torch.softmax(prong_logits, dim=-1),
        )

    if compile:
        forward = compile_step(forward, shapes)
    if graph:
        graphs = StepGraphs(torch.inference_mode()(lambda batch, norm, states: forward(
            batch, norm)), "predict step graph", shapes)
    device = next(model.parameters()).device
    context = quant.current()

    @torch.inference_mode()
    def step(batch, norm):
        if compile or graph:
            quant.check_context(context, "this compiled or graph predict step")
        if not graph or device.type != "cuda":
            return forward(batch, norm)
        captured = graphs.get(device, batch, norm)
        captured.load(batch, norm)
        return captured.replay()

    if graph:
        step.graphs, step.model = graphs, model
        step.key = (compile, context)
    return step


def graph_predict_step(model, compile: bool, shapes: int):
    """``make_predict_step(model, compile, shapes, graph=True)``, kept on
    ``model`` so that later calls for it replay the graphs already
    captured, as compiled graphs are kept (each call raises the bound by
    its ``shapes``, as ``compile_step`` raises the recompile limit).  The
    steps are kept by ``key``, ``(compile, ops.quant.current())``: graphs
    captured with float convs never replay inside an int8 context, nor int8
    graphs outside it or in another context.  The steps of one int8 context
    are kept at a time, beside the float ones."""
    key = (compile, quant.current())
    steps = model.__dict__.setdefault("_graph_predict_steps", {})
    step = steps.get(key)
    if step is None or step.model is not model:
        if key[1] is not None:
            for other in [k for k in steps if k[1] not in (None, key[1])]:
                del steps[other]
        step = steps[key] = make_predict_step(model, compile, shapes, graph=True)
    else:
        step.graphs.shapes += shapes
    return step


def predict_split(
    model,
    dataset,
    norm: Mapping[str, np.ndarray],
    batch_size: int,
    device,
    coo_granularity: int = 8192,
    fixed_shape: bool = False,
    prong_bucket_multipliers: Optional[Sequence[int]] = None,
    fold_eval_bn: bool = False,
    mesh: Optional[Mesh] = None,
    compile: bool = False,
    graph: bool = False,
) -> Dict[str, np.ndarray]:
    """Batched inference over ``dataset`` (an ``EventDataset``, or anything
    with what ``Batcher.build_batch`` reads).

    Returns event probabilities/targets for every event and prong
    probabilities/targets for every *real* prong, plus each prong's owning
    event index.  The last batch is wrap-padded by the batcher and trimmed.
    ``prong_bucket_multipliers`` lays batches out as the ``Trainer``'s
    batchers do.  ``fold_eval_bn`` (the options' eval-time BatchNorm
    folding, :mod:`.ops.fold`) predicts with a folded copy of ``model`` and
    leaves ``model`` as it was.

    In a process group of more than one rank (``mesh``, by default every
    rank a data shard) every rank calls it: each global batch of
    ``batch_size`` events is laid out in one piece per data shard, this rank
    assembles and predicts only its own, and the probabilities and targets
    of the shards are gathered in order over the mesh's data group, so
    every rank returns the whole split.  A tensor-parallel model predicts
    through a copy of it with whole parameters, gathered once.
    ``compile`` predicts through the compiled step (:func:`make_predict_step`),
    one graph for each batch shape the batcher lays out
    (``Batcher.shape_bound`` of them at most).  ``graph`` predicts through
    the CUDA graph step, from pinned batches, and copies each batch's
    probabilities to pinned host memory without waiting: a batch's rows
    are read while the next batch runs.  In a group each rank replays its
    own graphs on its shard (the eval-mode forward of whole parameters
    holds no collective) and the rows are gathered as above.  Inside an
    int8 context (:func:`.ops.quant.quantized_convs`) ``compile`` and
    ``graph`` predict the quantized network, one dispatch a batch.
    """
    mesh = mesh or default_mesh()
    model = unsharded_copy(model)
    if fold_eval_bn:
        model = folded_copy(model)
    size = mesh.dp
    batcher = Batcher(
        dataset,
        batch_size=batch_size,
        prong_bucket_multipliers=prong_bucket_multipliers,
        coo_granularity=coo_granularity,
        num_shards=size,
        drop_last=False,
        fixed_shape=fixed_shape,
        local_shards=local_shard_ids(mesh) if size > 1 else None,
    )
    shapes = batcher.shape_bound() if compile or graph else 1
    step = (graph_predict_step(model, compile, shapes) if graph
            else make_predict_step(model, compile, shapes))
    norm_t = to_device(norm, device)
    ev_probs, ev_targets = [], []
    pr_probs, pr_targets, pr_event = [], [], []
    seen = 0
    queued = torch.device(device).type == "cuda" and graph
    pending = None     # (host probabilities, their copy's event, batch)
    outputs = {}       # two pinned output buffers a shape, taken in turns
    batches = (batcher.prefetch_epoch(0, transform=pinned) if queued
               else batcher.prefetch_epoch(0))
    for i, batch in enumerate(itertools.chain(batches, [None] if queued else [])):
        if queued:
            # the graph's outputs to pinned memory behind the replay; the
            # batch before it is read meanwhile
            ready, pending = pending, None
            if batch is not None:
                probs = step(batch, norm_t)
                key = tuple(tuple(p.shape) for p in probs)
                if key not in outputs:
                    outputs[key] = [[torch.empty(p.shape, dtype=p.dtype, pin_memory=True)
                                     for p in probs] for _ in range(2)]
                host = outputs[key][i % 2]
                for h, p in zip(host, probs):
                    h.copy_(p, non_blocking=True)
                event = torch.cuda.Event()
                event.record()
                pending = (host, event, {k: batch[k].numpy() for k in
                                         ("event_targets", "prong_targets")})
            if ready is None:
                continue
            host, event, batch = ready
            event.synchronize()
            probs_e, probs_p = (h.numpy().copy() for h in host)
            event_targets, prong_targets = batch["event_targets"], batch["prong_targets"]
            if size > 1:
                probs_e, probs_p, event_targets, prong_targets = all_gather_rows([
                    torch.from_numpy(a) for a in (probs_e, probs_p, event_targets,
                                                  prong_targets)], mesh.data_group)
        elif size == 1:
            probs = step(to_device(batch, device), norm_t)
            probs_e, probs_p = (p.cpu().numpy() for p in probs)
            event_targets, prong_targets = batch["event_targets"], batch["prong_targets"]
        else:  # this shard's rows -> the global batch's, in shard order
            probs = step(to_device(batch, device), norm_t)
            probs_e, probs_p, event_targets, prong_targets = all_gather_rows([
                *probs, torch.from_numpy(batch["event_targets"]),
                torch.from_numpy(batch["prong_targets"])], mesh.data_group)
        take = min(batch_size, len(dataset) - seen)
        mask = prong_targets[:take] >= 0
        ev_probs.append(probs_e[:take])
        targets = event_targets[:take]
        if model.cfg.num_generation_classes:
            # scores are the 4-way current head; remap targets to match
            targets = split_current_targets(targets)
        ev_targets.append(targets)
        pr_probs.append(probs_p[:take][mask])
        pr_targets.append(prong_targets[:take][mask])
        pr_event.append(np.nonzero(mask)[0] + seen)
        seen += take

    return {
        "event_probabilities": np.concatenate(ev_probs),
        "event_targets": np.concatenate(ev_targets),
        "prong_probabilities": np.concatenate(pr_probs),
        "prong_targets": np.concatenate(pr_targets),
        "prong_event_index": np.concatenate(pr_event),
    }
