"""``torch.compile`` for the port's steps: the counterpart of ``jax.jit``.

The JAX package jits its predict, eval and train steps, one executable a
batch shape.  :func:`compile_step` compiles a step function the same way:
Inductor, static shapes (``dynamic=False``), so each shape the
:class:`..data.Batcher` lays out (each rung of its prong-capacity ladder and
hit-bank bucket) is one graph, compiled at its first batch and reused after.
Dynamo counts its recompiles against one limit per code object, and the
steps that :func:`..predict.make_predict_step` and the train and eval step
makers build share their makers' code objects, so each call raises the
limit by the shapes its step may meet (:meth:`..data.Batcher.shape_bound`):
the limit bounds the graphs of every step a process has made.  Reaching it
raises (``fail_on_recompile_limit_hit``) instead of running the step
eagerly: a step asked to compile never runs uncompiled without saying so.

Kernels K1 and K2 are custom ops (``tcvn::densify``,
``tcvn::coo_stem_scatter``), so the graph keeps their launches; sync-BN's
all-reduce is a functional collective inside the graph.  Inductor compiles
the C++ of CPU graphs with :func:`..aoti.inductor_compiler`, and its caches
live where :func:`.cache.enable_compile_cache` puts them.

Each step is one Dynamo graph (``fullgraph``) or its first call raises: a
graph break would run the code around it eagerly (inside a checkpoint, the
whole rematted region).  A remat body (:func:`..ops.masked.remat`) hands
its BatchNorms' running-statistic updates out through a Python list, a
side effect inside the checkpoint that Dynamo traces only when told that
the recompute need not repeat it
(``skip_fwd_side_effects_in_bwd_under_checkpoint``), which is the remat
contract: the recompute computes activations only.  That Dynamo setting is
process-wide, so a compiled step sets it only around its own calls.
"""

from __future__ import annotations

import functools
from typing import Callable

import torch

from .cache import enable_compile_cache


def _raise_recompile_limit(shapes: int):
    config = torch._dynamo.config
    config.recompile_limit += int(shapes)
    config.accumulated_recompile_limit = max(config.accumulated_recompile_limit,
                                             config.recompile_limit)
    config.fail_on_recompile_limit_hit = True


def compile_step(fn: Callable, shapes: int = 1) -> Callable:
    """``fn`` compiled by Inductor with static shapes, one Dynamo graph,
    for ``shapes`` more batch shapes under Dynamo's recompile limit; a
    graph break, or a shape past the limit, raises."""
    from ..aoti import inductor_compiler

    enable_compile_cache()
    torch._inductor.config.cpp.cxx = (inductor_compiler(),)
    _raise_recompile_limit(shapes)
    compiled = torch.compile(fn, backend="inductor", dynamic=False, fullgraph=True)

    @functools.wraps(fn)
    def call(*args, **kwargs):
        with torch._dynamo.config.patch(skip_fwd_side_effects_in_bwd_under_checkpoint=True):
            return compiled(*args, **kwargs)

    return call
