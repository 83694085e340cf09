#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py

Phases, each of which raises on failure, run in the order 1-9, 11-13,
14, 15, 17's compiled step, 16, 18, 20.  Beside them, in processes of their
own: the slowest of the graphs that phases 15 and 17 load from the
compile cache compile beside phases 1-12 at a low priority; the rest,
and phase 14's compiled ranks, compile beside 13; phases 10, 17 (but
its compiled step) and 19 run one after the other in one process while
phase 13's main process compiles, and 13 times its packages only once
that process has ended, so no two phases run on the card at once (a
compile's first call runs its graph there for seconds).  That process
runs phase 10, whose steps take up to 34 GiB of the card, first, while
most of the compiles have not reached their first call on the card, then
17 (up to 20 GiB), then 19.  The readings that share the host's cores with compiles are those
of phases 8-12 (niced compiles), of 10, 17 and 19, and of 13.  The ``[time]``
lines count from the script's start, imports included.  Phases 1-7, 10, one-hot pixels in
12 and a step of 14 run the option file's network whole; phases 8, 9,
11-15 run its widths at a cut depth (``CUT_DEPTH``: one dense block of
one bottleneck, one encoder layer), so that the smoke, with the compiles
of phases 13 and 15 and the bench, fits its time limit:

1. Device and build: the card's name and power limit from ``nvidia-smi``;
   every kernel under ``dune_transformercvn_torch/csrc`` is built with
   ``nvcc`` and the host COO engine (``csrc/coo_engine.cpp``) with the C++
   compiler, one compiler process per source, all at once; TF32 is switched
   off so the float32 comparisons below are float32.
2. Kernel K1 (COO -> dense densify) against its plain PyTorch version on the
   card, at the serving path's shapes, float32 and bfloat16, plain and
   space-to-depth layout, on uniform banks with duplicate pixels, an empty
   image, coordinates out of range (negative too) and padding rows past
   ``starts[-1]``, and on the event and prong banks of one real batch of
   16 events (track-shaped hits); the median time of the kernel, the plain
   version and one ``index_put_`` call, the kernel's device time (calls
   queued behind a device sleep, so no host time between them), its share
   of its bound, and its time on the same bank with every CSR range empty
   (the zero fill alone).
3. Kernel K2 (the coo stem's scatter) against its plain version on the
   card, at the coo path's shapes (event banks of 16 and 64 images, prong
   banks of 128 and 384, the real batch's two banks, production stem
   weights), float32 and bfloat16 output, the same edge cases; its binning
   pass against the plain binning; gradients through ``tcvn::coo_stem_scatter``
   against autograd of the plain version; the same times as K1 (library
   call: ``zeros().index_add_``, the bias, the cast), and the device time
   of its binning pass alone.
4. Dense serving at full width: the production option file, bfloat16,
   random weights from a seed, events made in memory from a seed;
   ``predict_split`` at batch 16 and at batch 64, one warm-up pass over the
   same events, then timed passes; K1 launched twice a batch, K2 never.
5. Coo serving: the same with the coo family; K2 twice a batch, K1 never.
6. Coo training at full width: the option file's AdamW, schedule, clip 43,
   dropout 0.1, pixel noise 0.001, bfloat16, batch 16: 3 warm-up steps and
   10 timed ones; finite loss and grad_norm, every parameter that got a
   gradient changed, BatchNorm statistics moved, K2 twice a step; then one
   eval pass over 64 events with finite AUCs.
7. Paths, float32: dense through K1 against the plain densify; coo logits
   against dense logits with the same weights; each coo embedder through K2
   against the plain stem; the card against the CPU at batch 4, both
   families.
8. The Trainer on the card: the production option file at ``CUT_DEPTH``
   (``num_gpu`` 4, clamped to one device), dense family, bfloat16, batch
   16, events made in memory (512 training, 64 validation), a run dir in a
   temporary directory; ``fit(max_steps=24, eval_interval=12)`` with a
   snapshot of the state on the host at step 12; finite loss and AUCs,
   checkpoints 12 and 24 indexed, K1 twice a step and a validation batch,
   K2 never; a fresh Trainer's ``resume(step_12)`` equal to the snapshot bit
   for bit, then ``fit(max_steps=16)`` with a finite loss; ``evaluate_run``
   of the best checkpoint with finite AUCs and K1 twice a batch; the median
   events/s the Trainer logged over windows with no validation, beside the
   same Trainer's step timed bare in the same process; the time of a
   synchronous checkpoint save of the full state.  Then the memory options:
   the dense b16 train step's ms/step and peak memory with ``remat_cnn``
   and with ``remat_embedder`` beside the plain step's (reported only).
9. Data-parallel training: 2 ranks of a process group, over ``nccl`` on
   2 cards when there are 2, else over ``gloo`` with CUDA tensors on the
   one card (the line says which); the production option file (``num_gpu``
   4, clamped to the world of 2), dense, bfloat16, batch 8 a rank (16 a
   step), sync-BN; ``fit(max_steps=6)`` with one validation over 64
   events, then ``predict_split`` of those events; the ranks' parameters
   and BatchNorm statistics equal bit for bit, their predictions equal with
   one row per event in order, finite losses, K1 twice a step, a
   validation batch and a predicted batch on each rank; ms/step (the step
   timed bare, with sync-BN and again with it off) and peak memory per
   rank.  Then a world of one over ``nccl`` against no process group: the
   Trainer's states after 3 steps equal bit for bit.
   ``check_data_parallel(smi, ranks, batch)`` runs other worlds (e.g. the
   option file's 4 devices at batch 16 on a machine with 4 cards).
10. The other embedder families at the option file's width, bfloat16,
   random weights from a seed, each path with the kernel counts reset
   before it and K1 asserted twice a batch and a step.  sdxl with
   ``embedder_chunk`` 16: ``predict_split`` at batch 16 and 64 (128 and 256
   events), a warm-up and one timed pass; the train step at batch 16, 2
   warm-up and 5 timed steps (ms/step,
   events/s, peak memory); the same with ``embedder_chunk_save_spatial``;
   the unchunked step at batch 8 (the largest the memory reckoning in
   PERF.md keeps far under 80 GB); and, in float32, the chunked network
   against the unchunked one at batch 4, logits and every gradient.
   sparse, convnext, fcnn, mobilenet and resnet: a warm-up and a timed
   ``predict_split`` pass at batch 16, and 1 + 3 train steps at batch 16
   (ms/step, peak memory).  ``check_families(smi)`` runs it alone.
11. Export and the serving variants, on the option file's dense network at
   full width, bfloat16, random weights from a seed and BatchNorm
   statistics from 4 train-mode forwards: ``export_model`` on the card with
   the ladder (4, 20) and ``bench_buckets`` (the export seconds and each
   rung's ``bucket_ms``), every artifact loaded back and held to the eager
   graph on a real event's pixel maps; ``predict_split`` at batch 16 with
   ``fold_eval_bn`` off and on, in turns (events/s; probabilities within
   2^-5); int8: scales calibrated on 4 batches, the quantized
   ``predict_split`` at batch 16 (events/s, argmax agreement and the
   largest probability difference against bfloat16), and one quantized
   batch in which every int8 convolution's ``torch._int_mm`` sums are held
   to the plain float64 route's, int32 equal.  Serving in one dispatch:
   each exported pid rung captured as one CUDA graph
   (``load_exported(..., graph=True)``) bit-equal to its program on 3
   events, the meta's ``graph_bucket_ms`` beside ``bucket_ms``, and the
   option file's full-depth network's pid rungs (P = 4, 20; its
   ``InferenceGraph`` modules, not exported) timed eager and captured,
   bit-equal; the int8 ``predict_split`` at batch 16 with ``graph=True``
   beside the bf16 graphs in turns (events/s), every pass bit-equal to the
   eager int8 pass, ``_int_mm`` once a quantized conv a replay.  K1 twice a
   batch (and a capture's warm-up) on every path; the exported graphs take
   dense pixel maps and launch no K1.
   ``check_serving_variants(smi, export_dir)`` runs it alone.
12. The modules outside the main path, at the option file's width.  Each
   of the eight optimizers (AdamW and the seven optax chains) steps the
   dense network at batch 16 from the same starting weights (ms/step, peak
   memory); lamb and lars fit 4 steps in a ``Trainer`` and a fresh Trainer
   resumed at step 2 ends equal to it bit for bit.  The general COO
   convolution on the batch-16 event bank, a 7x7/2 stem and a 3x3/1 layer:
   the native kernel maps equal to numpy's (host ms of each) and
   ``coo_conv_apply`` on the card against ``sparse_conv`` in float32.  The
   native CSR gather against the numpy loop on ``InMemoryEvents`` at batch
   16 and 64 (host ms).  ``DecoderLayer`` and the ISAB on the card against
   the CPU in float32, forward and gradients.  One-hot pixels (768
   channels): K1 against its plain version on a small bank and on a batch's
   event and prong banks (times against the bound), ``predict_split`` at
   batch 16, and the train step at batch 16, or the largest batch that
   fits, with its out-of-memory readings.  ``check_remaining_modules(smi)``
   runs it alone.
13. The AOTInductor serving package at the option file's widths and a cut
   depth (``CUT_DEPTH``: one bottleneck a dense block, one encoder layer,
   so that Inductor compiles each package in a fraction of the full
   network's minutes): that network exported as in phase 11 and its ``pid``
   programs at P = 4 and 20 packaged for the card (``aoti.package_run_dir``:
   each package's compile seconds, its per-event ``aoti_bucket_ms`` and,
   captured as one CUDA graph, ``aoti_graph_bucket_ms`` beside the eager
   program's ``bucket_ms``); each package captured
   (``load_package(..., graph=True)``) bit-equal to the package on 3 events;
   the C++ loader (``csrc/aoti_loader.cpp``, built with ``build_loader``)
   run as a subprocess on one real event's pixel maps at ``num_prongs`` 3
   and 17, without and with ``--graph``: the rung ``export.select_bucket``
   picks on the costs of that dispatch, outputs with the eager graph's
   argmax and within 2^-5 of its probabilities, its load time, capture
   time and time a run.  Inductor's kernels in the package are Inductor's; no
   ported kernel runs.
14. Tensor-parallel training (DP x TP on DTensor, the partitioned
   bottlenecks, attention heads and feed-forwards): dp1 x mp2 over 2
   ranks, ``gloo`` with CUDA tensors on the one card (``nccl`` where there
   are 2 cards; dp2 x mp2 over ``nccl`` on 4); the option file's dense
   network, bfloat16, ``DP_BATCH`` a data shard: ``fit`` of 4 steps with one
   validation and a checkpoint, a fresh Trainer resumed from it; every
   sharded tensor's piece 1/mp of the whole, the ranks' whole states equal
   bit for bit and equal to the resumed one, the losses against a
   world-of-one Trainer on the same global batches and seed (and the first
   step's again in float32), K1 twice a step and a validation batch on each
   rank; ms/step and peak memory per rank.  Then, in the same ranks, the
   full-depth network at batch 16 a data shard: each rank's eager step
   (ms/step, peak memory), beside a world of one's b16 step in the parent
   afterwards, whose peak must lie above each rank's.
   ``check_tensor_parallel(smi)`` runs it alone.  The compiled TP step
   (``compile=True``, ``CUT_DEPTH``, static shapes, dropout and noise 0)
   runs in two more ranks that compile, at a low priority, beside phase
   13 and are timed after it and after phase 15's graphs, which compile
   beside them too (``start_compiled_tp`` / ``finish_compiled_tp``): its
   first step against the eager TP step's on the same batch and weights,
   its first call's seconds (the compile), ms/step and K1 launches from
   inside the graph.
15. The compiled steps (``compile=True``, Inductor; the counterpart of the
   JAX package's ``jax.jit``), on the option file's dense network at
   ``CUT_DEPTH``, full width.  The eight graphs below, phase 17's compiled
   ``remat_cnn`` step and the bench's compile into an empty cache, one
   process each (``start_warming``), at a low priority: the four train
   graphs, the slowest, beside phases 1-12 (``EARLY_GRAPHS``), the rest
   beside phase 13; the smoke waits for them after
   phase 13 and before it times phase 14's compiled TP ranks.
   Then the port's bench
   (``python -m dune_transformercvn_torch.bench``) as a subprocess on the
   option file at ``CUT_DEPTH``; its JSON line is logged (serving at batch
   16 and 64 and the train step at batch 16 and 64, eager and compiled,
   with peak memory, compile seconds and MFU).  Then, each graph from the
   cache (the log gives each first call's hits and misses): bf16
   ``predict_split`` compiled against eager at batch 16 and 64 on the
   bench's events and static shapes (probabilities within 2^-5, argmax
   equal where eager's is clear; events/s of each, in turns); the bf16
   train step compiled at batch 16 with the option file's dropout and
   noise, 3 warm-up and 10 timed steps (ms/step, peak memory), and one
   compiled eval pass against eager's; the coo family's forward compiled
   at batch 16 with K2 inside the graph against eager; and, in float32
   with TF32 off, dropout and noise 0, the compiled predict step's
   probabilities and the compiled train step's first loss and gradient
   norm against eager's within PATH_TOL.  K1 and K2 launch twice a forward
   from inside the compiled graphs, and those launches count in the
   kernels' line.  ``check_compiled(smi)`` runs it alone.
16. CUDA graphs (``graph=True``; the counterpart of the JAX package's
   ``steps_per_dispatch`` and of ``jax.jit``'s one program a call), the
   option file's network whole, bf16.  ``predict_split(graph=True)``
   against eager at b16 and b64 (dense) and b16 (coo), static shapes,
   events/s in turns; the coo b16 train step as 3 replays of the one-step
   graph against eager, K2 inside.  ``Trainer(graph=True)`` at
   ``CUT_DEPTH`` with ``steps_per_dispatch`` 4: fit 8 steps with 2
   validations and checkpoints, a fresh Trainer resumed at step 4 equal to
   the snapshot bit for bit and fit on.  ``graph=True`` with
   ``compile=True`` at ``CUT_DEPTH``: phase 15's train and serving graphs
   from the cache, captured (no FX-graph cache miss).  Then the dense b16
   train step with the option file's dropout and noise: 4 replays of a
   4-step graph against 16 eager steps from the same state (both with the
   graph-safe AdamW): metrics, parameters, running statistics and moments
   bit for bit, or within 2^-7 with the cause printed (two eager runs
   against each other); ms/step of each over the last 12 steps beside the
   host's dispatch time, peak memory, the graph's reserved memory after
   its capture (under twice eager's peak), K1's launches a replay; last,
   one replay under ``torch.profiler``, K1's kernel in the trace as often
   as the count says.  K1 and K2 launch from the graphs' replays, and
   those launches count in the kernels' line.  ``check_graphs(smi)`` runs
   it alone.
17. The memory recipes and the optax chains in one dispatch.  In a
   process of its own started with phase 13, then phase 10 in it
   (``Side``; their timings share the host with the compiles), at ``CUT_DEPTH``,
   bf16, b16, static shapes, the option file's dropout and noise: each of
   the seven optax chains as 2 replays of a 2-step graph against 4 eager
   steps from the same state (metrics, parameters, statistics, the
   chain's slots and count bit for bit, or within 2^-7 with the cause
   printed); ``remat_embedder`` the same for dense (K1 2 a step) and coo,
   whose stem lies inside the rematted embedder, so the backward's
   recompute launches K2 again: 4 a step.  At full width: the sdxl b16
   step with ``embedder_chunk`` 16 as replays of the one-step graph
   against eager (ms/step, peak); the dense b16 step with ``remat_cnn``
   as 4 replays of a 4-step graph against 16 eager steps, as phase 16
   does without remat (ms/step, peak and reserved memory).  After phase
   15, in the smoke's process: the compiled ``remat_cnn`` step from the
   cache (warmed beside phase 13 with phase 15's graphs): first call,
   ms/step and peak beside the compiled plain step's.  K1 and K2 launches
   from these paths count in the kernels' line.
   ``check_recipes(smi, compiled=False)`` runs it alone in one process.
   ``recipes_probe.py`` holds this slice's readings outside the smoke.
18. Multi-card training in one dispatch (``graph=True`` in a process
   group: the step's all-reduces, sync-BN's, the tensor-parallel row's
   and ``global_norm``'s inside the CUDA graph, on nccl).  On one card:
   ``Trainer(graph=True)`` at ``CUT_DEPTH``, 2 steps a replay, in a world
   of one over nccl against the same Trainer with no process group, its
   state bit for bit (``check_world_of_one(graph=True)``); the multi-card
   part prints a line saying it needs 2 or 4 cards.  On 4 cards (2: dp2
   and dp1 x mp2), one process a card (``check_graph_parallel(smi)``):
   the option file's network whole, bf16, b16 a data shard, static
   shapes, sync-BN, its dropout and noise; a world of one first, then dp4,
   then dp2 x mp2, each from the same seeded start: 16 eager steps, 4
   replays of a 4-step graph, 16 of the one-step graph (world of one and
   dp4), and the 4-step graph with sync-BN off (dp4); each graph run's
   metrics, whole parameters, running statistics and AdamW's moments
   against the eager run's on every rank, bit for bit (or within 2^-7
   with the cause printed), the ranks' whole states equal, K1 twice a step
   from the replays; per rank ms/step over the last 12 steps, the host's
   part, events/s over the ranks, first call seconds and peak memory.
19. Sustained training (``sustained_train.run``, the port of
   ``tools/sustained_train.py``), in the side process after phase 17:
   ``Trainer.fit`` on the option file at ``CUT_DEPTH``, bf16, batch 16,
   as 4-step CUDA graphs, 96 steps with a validation every 48, on the
   twin of ``make_synthetic_file``'s events at seed 11 made in memory
   (1,000 events).  Every logged loss finite; K1 twice a step and a
   validation batch, plus the warm-up before each graph's capture; K2
   never; an ``events_per_second`` window logged in each validation
   interval, ``val_epoch_AUC`` and the train metrics at each validation;
   the mean ``train_loss`` logged over the last
   validation interval below the first's.  Prints the windows, the
   steady state, the AUC curve and the peak memory.
20. A JSON line of every ported kernel, then, as the last line,
   ``{"ok": true, "device": {...}}``.

Exits non-zero, printing no result, when CUDA is unavailable.
"""

from __future__ import annotations

import time

# the [time] lines count from here, the imports below included
STARTED = time.perf_counter()

import contextlib
import copy
import dataclasses
import datetime
import gc
import hashlib
import itertools
import json
import math
import os
import shutil
import statistics
import struct
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from dune_transformercvn_torch import Options
from dune_transformercvn_torch.data import Batcher, InMemoryEvents
from dune_transformercvn_torch.models import (DecoderLayer, InducedSetAttentionBlock,
                                              TransformerCVN)
from dune_transformercvn_torch.models.densenet import densenet_post_stem
from dune_transformercvn_torch.ops import coo_stem
from dune_transformercvn_torch.ops.masked import sync_batch_norm
from dune_transformercvn_torch.ops.coo_conv import (build_conv_maps, build_conv_maps_numpy,
                                                    coo_conv_apply, coo_stem_conv_plain)
from dune_transformercvn_torch.ops.sparse import SparseGrid, sparse_conv
from dune_transformercvn_torch.ops.densify import (
    densify_images_cuda, densify_images_plain)
from dune_transformercvn_torch.evaluate import evaluate_run
from dune_transformercvn_torch.aoti import load_package, package_run_dir
from dune_transformercvn_torch.export import (_time_bucket_ms, build_inference_fn, export_model,
                                              load_exported, select_bucket, with_max_prongs)
from dune_transformercvn_torch.utils.graphs import EventGraph
from dune_transformercvn_torch.ops import quant
from dune_transformercvn_torch.ops.fold import folded_copy
from dune_transformercvn_torch.predict import predict_split, to_device
from dune_transformercvn_torch.profile_serving import OPTION_FILE, production_config
from dune_transformercvn_torch.train import (
    Trainer, create_train_state, finalize_metrics, init_metric_state, make_eval_step,
    make_train_step)
from dune_transformercvn_torch.train.checkpoint import CheckpointManager, to_host
from dune_transformercvn_torch.train.logging import read_history
from dune_transformercvn_torch.utils.build import (build, build_host, build_loader,
                                                   host_sources, sources)
from dune_transformercvn_torch.utils.cache import enable_compile_cache
from dune_transformercvn_torch import bench, sustained_train
from dune_transformercvn_torch.predict import make_predict_step

SEED = 0
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA's data sheet
QUEUE_CYCLES = 10_000_000      # ~5 ms of device sleep ahead of a queued burst

H, W, C = 400, 280, 3
# K1 tolerances against the plain version (torch's index_put_).  float32:
# both add duplicates in bank order in float32.  bfloat16: the kernel rounds
# to bf16 after every add (as the TPU kernel does), the plain version on the
# card adds in float32 and rounds once; sums stay below ~4, so the gap is a
# few bf16 ulps of 2^-6.
K1_TOL = {torch.float32: dict(rtol=1e-6, atol=1e-5),
          torch.bfloat16: dict(rtol=2 ** -7, atol=2 ** -5)}
# K2 against its plain version: float32 sums in bank order against
# index_add_'s atomics in any order; a bfloat16 output rounds sums that agree
# to float32 rounding once, so they differ by at most one bf16 ulp.
K2_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
          torch.bfloat16: dict(rtol=2 ** -7, atol=2 ** -7)}
K2_GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
# Logits through a kernel against logits through its plain version, float32
# with TF32 off: only cuDNN/cuBLAS summation order separates them.
PATH_TOL = dict(rtol=1e-4, atol=1e-4)
# coo against dense logits: the stem's float32 sums in another order,
# amplified by the BatchNorm divides (tests/test_coo_embedder.py's bound).
FAMILY_TOL = dict(rtol=1e-3, atol=1e-4)
# Serving: (batch size, events) -- one to two seconds a pass, which leaves
# phase 16 its time -- and the timed passes after the warm-up.
SERVE_EVENTS = ((16, 256), (64, 512))
SERVE_PASSES = 3
# Training: the option file's batch size, warm-up and timed steps, and the
# events of the eval pass.
TRAIN_BATCH, TRAIN_WARMUP, TRAIN_STEPS, EVAL_EVENTS = 16, 3, 10, 64
# The card against the CPU, float32: cuDNN and oneDNN sum in other orders
# through ~30 conv layers.
CPU_TOL = dict(rtol=1e-3, atol=1e-3)
# The Trainer: in-memory training and validation events, the fit's steps and
# validation interval, the metric-log cadence, and the resumed fit's limit.
FIT_EVENTS, FIT_VAL_EVENTS = 512, 64
FIT_STEPS, FIT_EVAL, FIT_LOG, RESUME_TO = 24, 12, 4, 16
# The same Trainer's step timed bare (batches already on the card, no loop
# around it), and the synchronous checkpoint saves timed at this width.
BARE_WARMUP, BARE_STEPS, SAVES = 2, 12, 3
# The memory options' readings: warm-up and timed steps of each variant.
REMAT_WARMUP, REMAT_STEPS = 2, 5
# Data-parallel training: ranks, batch a rank, training and validation
# events, steps (one validation, at the last), the bare steps timed after,
# and the world-of-one comparison's steps.
DP_RANKS, DP_BATCH, DP_EVENTS, DP_VAL_EVENTS, DP_STEPS = 2, 8, 512, 64, 6
DP_BARE_WARMUP, DP_BARE_STEPS, ONE_RANK_STEPS = 1, 4, 3
DP_TIMEOUT_S = 400
# Phase 18's world of one: the graph Trainer's steps a replay and steps.
ONE_RANK_GRAPH_K, ONE_RANK_GRAPH_STEPS = 2, 4
# Phase 10.  sdxl: the chunk, the save-spatial threshold of its selective
# remat (conv outputs of 100x70 and smaller are kept), the unchunked step's
# batch, warm-up and timed steps of the chunked step and of each reading,
# and the float32 chunked-vs-unchunked check's batch and chunk.
SDXL_CHUNK, SDXL_SAVE_SPATIAL, SDXL_UNCHUNKED_BATCH = 16, 7000, 8
SDXL_SERVE_EVENTS = ((16, 128), (64, 256))
SDXL_WARMUP, SDXL_STEPS, SDXL_READING_WARMUP, SDXL_READING_STEPS = 2, 5, 1, 3
SDXL_CHECK_BATCH, SDXL_CHECK_CHUNK = 4, 4
# Chunked against unchunked sdxl, float32, TF32 off: logits; and each
# gradient within CHUNK_GRAD_SHARE of its tensor's largest element (a
# parameter's gradient sums over every pixel of the bank, chunk by chunk)
# plus CHUNK_GRAD_FLOOR of the network's largest (a gradient that cancels to
# ~1e-6 of the rest, as the position vectors' does, keeps the rounding of
# the terms it cancels).
CHUNK_TOL = dict(rtol=1e-4, atol=1e-4)
CHUNK_GRAD_SHARE, CHUNK_GRAD_FLOOR = 1e-3, 1e-5
# The other families: events of the serving pass, warm-up and timed steps.
OTHER_FAMILIES = ("sparse", "convnext", "fcnn", "mobilenet", "resnet")
FAMILY_SERVE_EVENTS, FAMILY_WARMUP, FAMILY_STEPS = 128, 1, 3
# Phase 11: the export ladder (the full capacity 20 is added), the events
# of the fold and int8 passes, the train-mode forwards that give the
# BatchNorm statistics, and the calibration batches.
EXPORT_LADDER, VARIANT_EVENTS, STAT_FORWARDS, CALIBRATION_BATCHES = (4,), 256, 4, 4
# An artifact against the eager graph, bfloat16: the exported program runs
# the same ATen ops, some decomposed, so a bf16 rounding may land apart;
# probabilities within 2^-6, hidden vectors within 2^-5 of their largest.
EXPORT_PROB_TOL, EXPORT_HIDDEN_SHARE = 2 ** -6, 2 ** -5
# Folded against raw probabilities: 2^-5 of the largest (bf16 activations
# of a folded and an unfolded conv round apart, PERF.md's bf16 bound).
FOLD_SHARE = 2 ** -5
# The one-event rungs the option file's full-depth network is timed at,
# eager and as one CUDA graph (its InferenceGraph modules, not exported:
# an export at full depth would cost the smoke minutes).
FULL_DEPTH_RUNGS = (4, 20)
# Phase 12.  The optimizers (each from the same starting weights): warm-up
# and timed steps; lamb's and lars's Trainer fit and its checkpoint step.
OPTIMIZERS = ("adamw", "adam", "sgd", "rmsprop", "adagrad", "lamb", "lars", "lion")
OPT_WARMUP, OPT_STEPS = 1, 3
RESUME_OPTIMIZERS, RESUME_FIT, RESUME_AT = ("lamb", "lars"), 4, 2
# The COO convolution's layers on the b16 event bank: the 7x7/2 stem (3 ->
# 64) and a 3x3/1 layer (64 -> 64) on the stem's output sites; the host
# timings' repeats.  Against sparse_conv on the card, float32, TF32 off:
# sums of up to 9 * 64 products of O(1) terms in other orders, so a few
# 1e-6; the JAX package holds its two engines to 1e-5 on small grids.
COO_LAYERS = (("stem 7x7/2", 7, 2, 64), ("3x3/1", 3, 1, 64))
HOST_REPEATS = 20
COO_CONV_TOL = dict(rtol=1e-4, atol=1e-4)
# The CSR gather: events, and the batch sizes of the indices.
GATHER_EVENTS, GATHER_BATCHES = 512, (16, 64)
# DecoderLayer and ISAB, the card against the CPU in float32 (TF32 off):
# batch, tokens, hidden, heads, inducing points; outputs within DECODER_TOL,
# each gradient within DECODER_GRAD_SHARE of its largest element (sums over
# 64 x 21 tokens in other orders).
DECODER_SHAPE = (64, 21, 128, 8, 8)
DECODER_TOL = dict(rtol=1e-4, atol=1e-4)
DECODER_GRAD_SHARE = 1e-4
# One-hot pixels (768 channels): serving events and passes, the train
# step's batch sizes tried in turn until one fits, warm-up and timed steps,
# the small bank's images, and the images a plain densify compares at once.
ONE_HOT_EVENTS, ONE_HOT_PASSES = 64, 3
ONE_HOT_TRAIN_BATCHES, ONE_HOT_WARMUP, ONE_HOT_STEPS = (16, 12, 8, 4), 1, 2
ONE_HOT_SMALL, ONE_HOT_CHUNK = 2, 8
# Phase 13: the rungs packaged from phase 11's export (4 and the full 20),
# the prong counts the C++ loader serves (3 takes rung 4 when it is the
# cheaper, 17 only fits 20), the loader's timed runs after its first, and
# its time limit.  Against the eager graph the package runs Inductor's
# fusions of the same bf16 ops: argmax equal, probabilities within
# FOLD_SHARE.
AOTI_RUNGS, AOTI_PRONGS, AOTI_REPEAT, AOTI_TIMEOUT_S = (4, 20), (3, 17), 20, 300
# Phase 14: the TP degree, the steps (one validation and a checkpoint at the
# last), the bare steps timed after, and the ranks' time limit.  Losses
# against a world-of-one Trainer on the same global batches and seed: the
# first step is a forward of the same weights on the same batch, so in
# float32 its loss is within PATH_TOL; in bf16 each row-parallel layer's
# partial products round to bf16 before the row sums them, and the later
# steps follow updates whose float-order differences (cuDNN's weight
# gradients sum in no fixed order) the bf16 activations and AdamW's
# normalised steps carry, so every bf16 loss within bf16's rounding, 2^-7.
TP_MP, TP_STEPS, TP_BARE_WARMUP, TP_BARE_STEPS, TP_TIMEOUT_S = 2, 4, 1, 4, 600
TP_LOSS_TOL = dict(rtol=2 ** -7, atol=2 ** -7)
# The compiled TP step at CUT_DEPTH (its first call compiles): warm-up and
# timed steps; against the eager TP step's first loss within TP_LOSS_TOL
# (the compiled kernels keep float32 inside a fusion where eager rounds
# every op to bf16).  The full-depth network: batch a data shard, warm-up
# and timed steps of each TP rank and of the world of one.
TP_COMPILED_WARMUP, TP_COMPILED_STEPS = 1, 4
TP_FULL_BATCH, TP_FULL_WARMUP, TP_FULL_STEPS = 16, 1, 2
# Phases 13 and 15 compile with Inductor, which takes minutes a graph at
# full depth (the b16 serving graph compiled cold in 328-363 s on the H100
# host, PERF.md): they, and phases 8, 9, 11, 12 and 14 to leave them the
# time, run the option file's widths at a cut depth, one dense block of
# one bottleneck and one encoder layer.
CUT_DEPTH = dict(densenet_structure=(1,), num_encoder_layers=1)
# Phase 15: the graphs compiled side by side into the cache before the
# bench and the checks, one process each, with this many Inductor compile
# workers each, and their time limit; the bench's time limit; the compiled
# bf16 train step's warm-up and timed steps.  Compiled against eager in
# bfloat16: the
# compiled kernels keep float32 inside each fused kernel where eager
# rounds every op to bf16, so probabilities within FOLD_SHARE, and argmax
# equal wherever eager's two largest probabilities lie more than
# 2 FOLD_SHARE apart (closer ones may swap within the tolerance).
WARM_GRAPHS = ("serve_b16", "serve_b64", "train_b16", "train_b64", "eval_b16", "coo_b16",
               "float32_predict", "float32_train", "remat_train_b16")
# the slowest of them (train graphs: 300-520 s each beside phase 13's
# compiles on the H100 host), compiled beside phases 1-12 instead
EARLY_GRAPHS = ("train_b16", "train_b64", "remat_train_b16", "float32_train")
WARM_THREADS, WARM_TIMEOUT_S = 2, 600
BENCH_TIMEOUT_S = 600
COMPILED_WARMUP, COMPILED_STEPS = 3, 10
# Phase 16: the dense train graph's K and its replays (4 x 4 = 16 steps
# against 16 eager steps from the same state) and the replays timed; the
# serving graphs' (batch size, events); the coo one-step graph's replays;
# the graph Trainer's fit and its validation interval.  Graph against eager:
# the same kernels on the same inputs, so bit for bit; where not, within
# bf16's rounding, 2^-7 of each tensor's largest, with the cause printed.
GRAPH_K, GRAPH_REPLAYS, GRAPH_TIMED = 4, 4, 3
GRAPH_SERVE_EVENTS = ((16, 128), (64, 256))
GRAPH_COO_STEPS, GRAPH_FIT_STEPS, GRAPH_FIT_EVAL = 3, 8, 4
GRAPH_TOL = 2 ** -7
# Phase 17: the chains' graph K, replays and steps; the remat_embedder
# graphs' K and replays; the sdxl graph's chunk and its eager steps and
# replays (after the first of each); the compiled remat_cnn step's warm-up
# and timed steps; the time limit of the process phases 10, 17 and 19 run in.
CHAIN_K, CHAIN_REPLAYS = 2, 2
RECIPE_K, RECIPE_REPLAYS = 2, 2
SDXL_GRAPH_CHUNK, SDXL_GRAPH_STEPS = 16, 3
REMAT_COMPILED_WARMUP, REMAT_COMPILED_STEPS = 2, 5
SIDE_TIMEOUT_S = 900
# Phase 18: the data- and tensor-parallel graphs, one process a card over
# nccl (on 2 or 4 cards; one card runs only the world of one): the option
# file's network whole, bf16, b16 a data shard, static shapes, sync-BN,
# its dropout and noise.  Each run takes PAR_STEPS steps from the same
# start; a graph run as PAR_STEPS / K replays of a K-step graph; ms/step
# over the last PAR_TIMED steps.  The runs of each layout: (name, K,
# graph, sync-BN).  Graph against eager: bit for bit, or within GRAPH_TOL
# with the cause printed (two eager runs against each other).
PAR_STEPS, PAR_K, PAR_TIMED = 16, 4, 12
PAR_RUNS = {
    "one": (("eager", 1, False, True), ("graph_k4", PAR_K, True, True),
            ("graph_k1", 1, True, True)),
    "dp": (("eager", 1, False, True), ("graph_k4", PAR_K, True, True),
           ("graph_k1", 1, True, True), ("graph_k4_unsynced", PAR_K, True, False)),
    "tp": (("eager", 1, False, True), ("graph_k4", PAR_K, True, True)),
}
PAR_TIMEOUT_S = 900
# Phase 19: sustained training through sustained_train.run on the twin of
# make_synthetic_file's events (seed 11): the option file at CUT_DEPTH, bf16,
# b16, as K-step CUDA graphs, this many steps and events, a validation every
# SUSTAINED_EVAL steps, a metric logged every K steps (the end of a dispatch).
# 1,000 events: 950 to train, 59 steps an epoch, so the option file's one
# warm-up epoch ends inside the run; 50 to validate, 4 batches.
SUSTAINED_STEPS, SUSTAINED_EVAL, SUSTAINED_EVENTS, SUSTAINED_K = 96, 48, 1000, 4


def log(msg: str = ""):
    print(msg, flush=True)


def reset_counts():
    densify_images_cuda.launches = 0
    coo_stem.scatter_patches_cuda.launches = 0


def read_counts():
    return densify_images_cuda.launches, coo_stem.scatter_patches_cuda.launches


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------

def device_and_build():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    names, hosts = sources(), host_sources()
    with ThreadPoolExecutor(len(names) + len(hosts)) as pool:
        host_libs = [pool.submit(build_host, name) for name in hosts]
        outputs = dict(zip(names, pool.map(build, names)))
        host_libs = [os.path.basename(f.result()) for f in host_libs]
    log(f"[build] {sorted(outputs)} built with nvcc, host {host_libs} with the C++ "
        f"compiler, in {time.perf_counter() - t0:.2f} s")
    for name, text in outputs.items():
        for line in text.splitlines():
            if "ptxas info" in line and ("registers" in line or "Used" in line):
                log(f"[build] {name}: {line.strip()}")

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log(f"[build] cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    return smi


# ---------------------------------------------------------------------------
# phases 2 and 3
# ---------------------------------------------------------------------------

def make_bank(rng, num_images, hits_per_image, bucket=8192):
    """An owner-sorted hit bank with the edge cases the batcher can produce."""
    counts = np.maximum(rng.poisson(hits_per_image, num_images), 1)
    counts[num_images // 3] = 0                      # an empty image
    n = int(counts.sum())
    owner = np.repeat(np.arange(num_images), counts).astype(np.int32)
    xy = np.stack([rng.integers(0, H, n), rng.integers(0, W, n)], 1).astype(np.int32)
    dup = rng.random(n) < 0.1                        # duplicate the previous hit
    dup[0] = False
    dup[1:] &= owner[1:] == owner[:-1]
    for i in np.nonzero(dup)[0]:
        xy[i] = xy[i - 1]
    bad = rng.choice(n, size=max(8, n // 100), replace=False)
    xy[bad[0::4], 0] = -1 - rng.integers(0, 5, len(bad[0::4]))   # x < 0
    xy[bad[1::4], 0] = H + rng.integers(0, 5, len(bad[1::4]))    # x >= H
    xy[bad[2::4], 1] = -1 - rng.integers(0, 5, len(bad[2::4]))   # y < 0
    xy[bad[3::4], 1] = W + rng.integers(0, 5, len(bad[3::4]))    # y >= W
    R = max(bucket, -(-n // bucket) * bucket)        # padding rows at the end
    xy_full = np.concatenate([xy, rng.integers(0, H, (R - n, 2)).astype(np.int32)])
    owner_full = np.concatenate([owner, np.full(R - n, num_images, np.int32)])
    values = rng.uniform(16.0, 255.0, (R, C)).astype(np.float32) / 255.0
    starts = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    return xy_full, values, owner_full, starts


def cuda_time_ms(fn, warmup=3, bursts=5, per_burst=20, queued=False):
    """Median over bursts of the mean time of one call, by CUDA events.
    ``queued``: the device first sleeps ~5 ms, so the host enqueues the whole
    burst ahead of it and the calls run back to back: the device's time,
    with no host time between calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(bursts):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(QUEUE_CYCLES)
        start.record()
        for _ in range(per_burst):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_burst)
    return statistics.median(times)


# (label, images, hits per image): the event and packed prong banks at batch
# 16 and 64 (prong slots from the batcher's capacity ladder)
BANKS = [("event b16", 16, 160.0), ("prong b16", 128, 160.0 / 3),
         ("event b64", 64, 160.0), ("prong b64", 384, 160.0 / 3)]
# the b16 forward's two banks, uniform (PR 2 and 3's row) and from a real batch
FORWARDS = {"uniform": ("event b16", "prong b16"),
            "serving": ("serving event b16", "serving prong b16")}


def bench_banks(seed):
    """Numpy banks ``(label, images, xy, values, owner, starts)``: the uniform
    banks of BANKS, then the event and prong banks of one ``Batcher`` batch of
    16 in-memory events (track-shaped hits, values scaled by 1/255 as
    ``preprocess_values`` does without noise)."""
    rng = np.random.default_rng(seed)
    for label, n, hits in BANKS:
        yield (label, n) + make_bank(rng, n, hits)
    batch = Batcher(InMemoryEvents(16, seed), batch_size=16).build_batch(np.arange(16))
    for key, n in (("event", 16), ("prong", batch["slot_batch"].shape[0])):
        yield (f"serving {key} b16", n, batch[f"{key}_xy"],
               batch[f"{key}_vals"] / np.float32(255.0), batch[f"{key}_owner"],
               batch[f"{key}_starts"])


def forward_totals(cases):
    """Sums of each timing over the two banks of each b16 forward in ``FORWARDS``."""
    return {name: {k: sum(cases[label][k] for label in labels)
                   for k in cases[labels[0]]}
            for name, labels in FORWARDS.items()}


def check_k1():
    """K1 against the plain version; returns (max abs err, kernel ms, plain
    ms, library ms, bound ms), the times summed over the two uniform banks
    of one batch-16 forward in bfloat16, plain layout (the serving path's
    calls)."""
    max_err = 0.0
    cases = {}
    log("[K1] case                                 max_abs_err  kernel_ms  device_ms  "
        "plain_ms   index_put_ms bound_ms  share  no_hit_ms")
    for label, n, xy, values, owner, starts in bench_banks(SEED):
        xy_t, owner_t = torch.from_numpy(xy).cuda(), torch.from_numpy(owner).cuda()
        starts_t = torch.from_numpy(starts).cuda()
        no_hits = torch.zeros_like(starts_t)
        x, y = xy_t[:, 0].long(), xy_t[:, 1].long()
        keep = (owner_t < n) & (x >= 0) & (x < H) & (y >= 0) & (y < W)
        flat = torch.where(keep, (owner_t.long() * H + x) * W + y, n * H * W)
        used = int(starts[-1])
        for dtype in (torch.float32, torch.bfloat16):
            vals_t = torch.from_numpy(values).to("cuda", dtype)
            for s2d in (False, True):
                out = densify_images_cuda(xy_t, vals_t, starts_t, n, H, W, s2d)
                ref = densify_images_plain(xy_t, vals_t, owner_t, n, H, W, s2d)
                torch.cuda.synchronize()
                assert out.shape == ref.shape and out.dtype == dtype, (out.shape, ref.shape)
                torch.testing.assert_close(out.float(), ref.float(), **K1_TOL[dtype])
                err = (out.float() - ref.float()).abs().max().item()
                max_err = max(max_err, err)
                # the output written once, the used hits and offsets read once
                nbytes = (out.numel() * out.element_size()
                          + used * (2 * 4 + C * vals_t.element_size()) + (n + 1) * 4)
                del out, ref
                bound = 1e3 * nbytes / HBM_BYTES_PER_S
                k_ms = cuda_time_ms(
                    lambda: densify_images_cuda(xy_t, vals_t, starts_t, n, H, W, s2d))
                d_ms = cuda_time_ms(
                    lambda: densify_images_cuda(xy_t, vals_t, starts_t, n, H, W, s2d),
                    queued=True)
                p_ms = cuda_time_ms(
                    lambda: densify_images_plain(xy_t, vals_t, owner_t, n, H, W, s2d))
                lib_ms = cuda_time_ms(lambda: vals_t.new_zeros((n * H * W + 1, C)).index_put_(
                    (flat,), vals_t, accumulate=True))
                empty_ms = cuda_time_ms(
                    lambda: densify_images_cuda(xy_t, vals_t, no_hits, n, H, W, s2d))
                name = f"{label} {str(dtype)[6:]} {'s2d' if s2d else 'nhwc'}"
                log(f"[K1] {name:<36} {err:<12.3g} {k_ms:<10.4f} {d_ms:<10.4f} "
                    f"{p_ms:<10.4f} {lib_ms:<12.4f} {bound:<9.4f} {bound / k_ms:<6.1%} "
                    f"{empty_ms:.4f}")
                if dtype == torch.bfloat16 and not s2d:
                    cases[label] = dict(kernel=k_ms, device=d_ms, plain=p_ms,
                                        library=lib_ms, bound=bound, no_hit=empty_ms)
    totals = forward_totals(cases)
    for name, t in totals.items():
        log(f"[K1] per b16 forward, {name} banks (2 banks, bf16): kernel "
            f"{t['kernel']:.4f} ms (device {t['device']:.4f}, no hits "
            f"{t['no_hit']:.4f}), plain {t['plain']:.4f} ms, index_put_ "
            f"{t['library']:.4f} ms, bound {t['bound']:.4f} ms, share of bound "
            f"{t['bound'] / t['kernel']:.1%} ({t['bound'] / t['device']:.1%} of device time)")
    t = totals["uniform"]
    return max_err, t["kernel"], t["plain"], t["library"], t["bound"]


def check_k2(stem_weight, stem_bias):
    """K2 against its plain version with the production stem (C_out 64);
    returns (max abs err, kernel ms, plain ms, library ms, bound ms), the
    times summed over the two uniform banks of one batch-16 forward with
    bfloat16 output (the coo path's calls)."""
    kernel = stem_weight.permute(2, 3, 1, 0).contiguous()          # HWIO
    bias = stem_bias.float().contiguous()
    out_h, out_w = coo_stem.out_shape(H, W)
    c_out = kernel.shape[-1]
    max_err = 0.0
    cases = {}
    log("[K2] case                                 max_abs_err  kernel_ms  device_ms  "
        "plain_ms   library_ms bound_ms  share  no_hit_ms")
    for label, n, xy, values, owner, starts in bench_banks(SEED + 1):
        xy_t, starts_t = torch.from_numpy(xy).cuda(), torch.from_numpy(starts).cuda()
        no_hits = torch.zeros_like(starts_t)
        vals_t = torch.from_numpy(values).cuda()
        patches = coo_stem.stem_patches(xy_t, vals_t, kernel, H, W).contiguous()
        flat, _ = coo_stem.tap_index(xy_t, starts_t, n, H, W)
        flat, rows = flat.reshape(-1), patches.reshape(-1, c_out)
        used = int(starts[-1])
        bins, entries = coo_stem.bin_hits_cuda(xy_t, starts_t, n, H, W, c_out)
        want_bins, want_entries = coo_stem.bin_hits_plain(xy_t, starts_t, n, H, W, c_out)
        listed = want_entries >= 0
        assert torch.equal(bins, want_bins), f"K2 binning, {label}: bins differ"
        assert torch.equal(entries[listed], want_entries[listed]), (
            f"K2 binning, {label}: hit lists differ")
        del bins, entries, want_bins, want_entries, listed
        for dtype in (torch.float32, torch.bfloat16):
            def run_kernel(starts=starts_t):
                return coo_stem.scatter_patches_cuda(patches, xy_t, starts, bias, n, H, W,
                                                     dtype)

            def run_plain():
                return coo_stem.scatter_patches_plain(patches, xy_t, starts_t, bias, n, H,
                                                      W, dtype)

            def run_library():
                grid = rows.new_zeros((n * out_h * out_w + 1, c_out)).index_add_(0, flat, rows)
                return (grid[:-1] + bias).to(dtype)

            out, ref = run_kernel(), run_plain()
            torch.cuda.synchronize()
            assert out.shape == ref.shape == (n, out_h, out_w, c_out) and out.dtype == dtype
            torch.testing.assert_close(out.float(), ref.float(), **K2_TOL[dtype])
            err = (out.float() - ref.float()).abs().max().item()
            max_err = max(max_err, err)
            del out, ref
            # the output written once; the used hits' patches, coordinates
            # and the offsets and bias read once
            nbytes = (n * out_h * out_w * c_out * dtype.itemsize
                      + used * (16 * c_out * 4 + 2 * 4) + (n + 1) * 4 + c_out * 4)
            bound = 1e3 * nbytes / HBM_BYTES_PER_S
            k_ms = cuda_time_ms(run_kernel)
            d_ms = cuda_time_ms(run_kernel, queued=True)
            p_ms = cuda_time_ms(run_plain, bursts=3, per_burst=5)
            lib_ms = cuda_time_ms(run_library, bursts=3, per_burst=5)
            empty_ms = cuda_time_ms(lambda: run_kernel(starts=no_hits))
            name = f"{label} out {str(dtype)[6:]}"
            log(f"[K2] {name:<36} {err:<12.3g} {k_ms:<10.4f} {d_ms:<10.4f} "
                f"{p_ms:<10.4f} {lib_ms:<10.4f} {bound:<9.4f} {bound / k_ms:<6.1%} "
                f"{empty_ms:.4f}")
            if dtype == torch.bfloat16:
                bin_ms = cuda_time_ms(
                    lambda: coo_stem.bin_hits_cuda(xy_t, starts_t, n, H, W, c_out),
                    queued=True)
                log(f"[K2]   {label}: the binning pass alone {bin_ms:.4f} ms of the "
                    f"device's {d_ms:.4f}")
                cases[label] = dict(kernel=k_ms, device=d_ms, plain=p_ms,
                                    library=lib_ms, bound=bound, no_hit=empty_ms)
        if label.endswith("b16") and not label.startswith("serving"):
            check_k2_gradients(patches, xy_t, starts_t, bias, n)
        del patches, flat, rows
        torch.cuda.empty_cache()
    totals = forward_totals(cases)
    for name, t in totals.items():
        log(f"[K2] per b16 forward, {name} banks (2 banks, bf16 out): kernel "
            f"{t['kernel']:.4f} ms (device {t['device']:.4f}, no hits "
            f"{t['no_hit']:.4f}), plain {t['plain']:.4f} ms, index_add_ + bias + cast "
            f"{t['library']:.4f} ms, bound {t['bound']:.4f} ms, share of bound "
            f"{t['bound'] / t['kernel']:.1%} ({t['bound'] / t['device']:.1%} of device time)")
    t = totals["uniform"]
    return max_err, t["kernel"], t["plain"], t["library"], t["bound"]


def check_k2_gradients(patches, xy, starts, bias, n):
    """Gradients wrt patches and bias: the op ``tcvn::coo_stem_scatter`` (K2
    forward, the registered gather backward) against autograd of the plain
    version."""
    cot = torch.randn((n,) + coo_stem.out_shape(H, W) + (patches.shape[-1],),
                      device="cuda", generator=torch.Generator("cuda").manual_seed(SEED))

    def grads(fn):
        p, b = patches.clone().requires_grad_(), bias.clone().requires_grad_()
        (fn(p, b) * cot).sum().backward()
        return p.grad, b.grad

    got = grads(lambda p, b: coo_stem.scatter_patches(p, b, xy, starts, n, H, W,
                                                      torch.float32))
    want = grads(lambda p, b: coo_stem.scatter_patches_plain(p, xy, starts, b, n, H, W,
                                                             torch.float32))
    for g, w, name in zip(got, want, ("patches", "bias")):
        torch.testing.assert_close(g, w, **K2_GRAD_TOL, msg=f"K2 gradient wrt {name}")
    log(f"[K2] gradients, {n} images: patches max diff "
        f"{(got[0] - want[0]).abs().max().item():.3g}, bias "
        f"{(got[1] - want[1]).abs().max().item():.3g} (tol {K2_GRAD_TOL})")


# ---------------------------------------------------------------------------
# phases 4 and 5
# ---------------------------------------------------------------------------

def serve(model, ds, batch_size):
    """One timed ``predict_split`` pass, with the kernels' counts reset
    just before it and read just after."""
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    out = predict_split(model, ds, ds.norm(), batch_size, "cuda")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts()
    num_batches = math.ceil(len(ds) / batch_size)
    want = ((0, 2 * num_batches) if model.cfg.embedder == "coo"
            else (2 * num_batches, 0))
    assert counts == want, (model.cfg.embedder, counts, want)

    n = len(ds)
    real_prongs = int((ds.prong_targets >= 0).sum())
    ev, pr = out["event_probabilities"], out["prong_probabilities"]
    assert ev.shape == (n, 4), ev.shape
    assert pr.shape == (real_prongs, 8), (pr.shape, real_prongs)
    assert np.isfinite(ev).all() and np.isfinite(pr).all()
    np.testing.assert_allclose(ev.sum(-1), 1.0, atol=1e-3)
    np.testing.assert_allclose(pr.sum(-1), 1.0, atol=1e-3)
    np.testing.assert_array_equal(out["event_targets"], ds.event_targets)
    return seconds, counts


def family_config(embedder, **fields):
    """The option file's network at full width in ``embedder``'s family."""
    return dataclasses.replace(production_config("bfloat16"), embedder=embedder, **fields)


def check_serving(embedder, cfg=None, sizes=SERVE_EVENTS, passes=SERVE_PASSES):
    """Returns the model and the kernels' launches over the timed passes
    (the warm-up pass's are asserted too)."""
    cfg = cfg or family_config(embedder)
    model = TransformerCVN(cfg, generator=torch.Generator().manual_seed(SEED))
    model = model.to("cuda").eval()
    log(f"[serve {embedder}] {os.path.basename(OPTION_FILE)}: densenet "
        f"{list(cfg.densenet_structure)} growth {cfg.densenet_growth_rate}, "
        f"initial_pixel_dim {cfg.initial_pixel_dim}, embedder_chunk {cfg.embedder_chunk}, "
        f"{cfg.num_encoder_layers} encoder layers, {cfg.compute_dtype}, "
        f"{sum(p.numel() for p in model.parameters())} parameters")
    total = np.zeros(2, np.int64)
    for batch_size, num_events in sizes:
        ds = InMemoryEvents(num_events, SEED + batch_size)
        # warm-up over the same events: the batcher's slot ladder gives the
        # prong bank several sizes, and the timed passes meet none anew
        serve(model, ds, batch_size)
        torch.cuda.reset_peak_memory_stats()
        rates = []
        for _ in range(passes):
            seconds, counts = serve(model, ds, batch_size)
            total += counts
            rates.append(num_events / seconds)
        log(f"[serve {embedder}] b{batch_size}: {num_events} events x {passes} "
            f"passes, median {statistics.median(rates):.1f} events/s, min "
            f"{min(rates):.1f}, max {max(rates):.1f} (predict_split, host batching "
            f"included); launches per pass K1 {counts[0]}, K2 {counts[1]}; peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return model, total


# ---------------------------------------------------------------------------
# phase 6
# ---------------------------------------------------------------------------

def check_training():
    """The coo family's train step at full width; returns K2's launches."""
    options = Options.load(OPTION_FILE)
    cfg = dataclasses.replace(production_config("bfloat16"), embedder="coo")
    assert (cfg.dropout, cfg.pixel_noise_std, options.gradient_clip) == (0.1, 0.001, 43)
    assert options.batch_size == TRAIN_BATCH and options.optimizer == "AdamW"
    steps = TRAIN_WARMUP + TRAIN_STEPS
    ds = InMemoryEvents(TRAIN_BATCH * steps, SEED + 3)
    batcher = Batcher(ds, batch_size=TRAIN_BATCH, shuffle=True, seed=SEED)
    batches = [to_device(b, "cuda") for b in batcher.epoch(0)]
    model = TransformerCVN(cfg, generator=torch.Generator().manual_seed(SEED)).to("cuda")
    state = create_train_state(model, options, ds.norm(), len(batcher), seed=SEED)
    step = make_train_step(model, options)
    log(f"[train] coo, {os.path.basename(OPTION_FILE)}: AdamW lr {options.learning_rate:g}, "
        f"warmup {options.learning_rate_warmup_epochs} epoch of {len(batcher)} steps, "
        f"clip {options.gradient_clip}, dropout {cfg.dropout}, pixel noise "
        f"{cfg.pixel_noise_std}, {cfg.compute_dtype}, batch {TRAIN_BATCH}")

    params_before = {n: p.detach().clone() for n, p in model.named_parameters()}
    stats_before = {n: b.clone() for n, b in model.named_buffers()}
    got_grad = set()
    torch.cuda.synchronize()
    reset_counts()
    for batch in batches[:TRAIN_WARMUP]:
        metrics = step(state, batch)
        got_grad |= {n for n, p in model.named_parameters() if bool(p.grad.any())}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for batch in batches[TRAIN_WARMUP:steps]:
        metrics = step(state, batch)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts()
    assert counts == (0, 2 * steps), (counts, steps)
    loss, grad_norm = float(metrics["train_loss"]), float(metrics["grad_norm"])
    assert math.isfinite(loss) and math.isfinite(grad_norm), (loss, grad_norm)
    unchanged = [n for n, p in model.named_parameters()
                 if n in got_grad and torch.equal(p.detach(), params_before[n])]
    assert not unchanged, f"parameters with a gradient that did not change: {unchanged}"
    moved = [n for n in stats_before if n.endswith("running_mean")
             and not torch.equal(dict(model.named_buffers())[n], stats_before[n])]
    num_bn = sum(n.endswith("running_mean") for n in stats_before)
    assert len(moved) == num_bn, (len(moved), num_bn)
    log(f"[train] coo b{TRAIN_BATCH}: {TRAIN_STEPS} steps after {TRAIN_WARMUP} warm-up, "
        f"{1e3 * seconds / TRAIN_STEPS:.2f} ms/step, "
        f"{TRAIN_BATCH * TRAIN_STEPS / seconds:.1f} events/s; last loss {loss:.5f}, "
        f"grad_norm {grad_norm:.4f}; {len(got_grad)} of {len(params_before)} parameters "
        f"got a gradient, all changed; {num_bn} BatchNorm means moved; launches K1 "
        f"{counts[0]}, K2 {counts[1]} ({steps} steps); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    eval_ds = InMemoryEvents(EVAL_EVENTS, SEED + 4)
    eval_step = make_eval_step(model, options)
    totals = init_metric_state(4, 8, options.auc_bins, "cuda")
    reset_counts()
    for batch in Batcher(eval_ds, batch_size=TRAIN_BATCH, drop_last=False).epoch(0):
        totals = eval_step(state, to_device(batch, "cuda"), totals)
    eval_counts = read_counts()
    assert eval_counts == (0, 2 * EVAL_EVENTS // TRAIN_BATCH), eval_counts
    result = finalize_metrics(totals)
    for key in ("event_epoch_AUC", "prong_epoch_AUC", "val_loss"):
        assert math.isfinite(result[key]), (key, result[key])
    log(f"[train] eval over {EVAL_EVENTS} events: event AUC "
        f"{result['event_epoch_AUC']:.4f}, prong AUC {result['prong_epoch_AUC']:.4f}, "
        f"val_loss {result['val_loss']:.5f}; K2 launches {eval_counts[1]}")
    return counts[1] + eval_counts[1]


# ---------------------------------------------------------------------------
# phase 7
# ---------------------------------------------------------------------------

def max_diff(a, b):
    return (a.float() - b.float()).abs().max().item()


def check_paths(bf16_model):
    cfg = production_config("float32")
    dense = TransformerCVN(cfg).eval()
    dense.load_state_dict(bf16_model.state_dict())
    dense = dense.to("cuda")
    coo = TransformerCVN(dataclasses.replace(cfg, embedder="coo")).eval()
    coo.load_state_dict(bf16_model.state_dict())
    coo = coo.to("cuda")
    ds = InMemoryEvents(16, SEED + 2)
    batch = Batcher(ds, batch_size=16).build_batch(np.arange(16))
    b = to_device(batch, "cuda")
    norm = to_device(ds.norm(), "cuda")
    P = b["slot_batch"].shape[0]
    with torch.inference_mode():
        ev_k, pr_k = dense(b, norm)
        images = [
            densify_images_plain(b[f"{k}_xy"], dense.preprocess_values(b[f"{k}_vals"]),
                                 b[f"{k}_owner"], n, H, W)
            for k, n in (("event", 16), ("prong", P))
        ]
        ev_p, pr_p, _, _ = dense.forward_from_images(
            *images, b["features"], b["extra"], b["prong_mask"],
            b["slot_batch"], b["slot_pos"], b["slot_mask"], norm)
        ev_c, pr_c = coo(b, norm)
    torch.testing.assert_close(ev_k, ev_p, **PATH_TOL)
    torch.testing.assert_close(pr_k, pr_p, **PATH_TOL)
    log(f"[paths] K1 vs plain densify, fp32 logits: event max diff "
        f"{max_diff(ev_k, ev_p):.3g}, prong {max_diff(pr_k, pr_p):.3g} (tol {PATH_TOL})")
    torch.testing.assert_close(ev_c, ev_k, **FAMILY_TOL)
    torch.testing.assert_close(pr_c, pr_k, **FAMILY_TOL)
    log(f"[paths] coo vs dense logits, same weights, fp32: event max diff "
        f"{max_diff(ev_c, ev_k):.3g}, prong {max_diff(pr_c, pr_k):.3g} (tol {FAMILY_TOL})")

    pe = coo.prong_embedding
    with torch.inference_mode():
        for key, n, net, mask in (("event", 16, pe.event_pixel_embedding, None),
                                  ("prong", P, pe.prong_pixel_embedding, b["slot_mask"])):
            values = coo.preprocess_values(b[f"{key}_vals"])
            via_k2 = net((b[f"{key}_xy"], values, b[f"{key}_owner"], n, b[f"{key}_starts"]),
                         mask)
            conv0 = net.features.conv0
            stem = coo_stem_conv_plain(b[f"{key}_xy"], values, b[f"{key}_owner"],
                                       conv0.weight.permute(2, 3, 1, 0), conv0.bias, n, H, W)
            via_plain = densenet_post_stem(net, stem, mask)
            torch.testing.assert_close(via_k2, via_plain, **PATH_TOL)
            log(f"[paths] coo {key} embedder through K2 vs the plain stem, fp32: max diff "
                f"{max_diff(via_k2, via_plain):.3g} (tol {PATH_TOL})")

    small = Batcher(ds, batch_size=4).build_batch(np.arange(4))
    for name, model in (("dense", dense), ("coo", coo)):
        with torch.inference_mode():
            ev_g, pr_g = model(to_device(small, "cuda"), norm)
            cpu_model = model.to("cpu")
            ev_cpu, pr_cpu = cpu_model(to_device(small, "cpu"), to_device(ds.norm(), "cpu"))
        torch.testing.assert_close(ev_g.cpu(), ev_cpu, **CPU_TOL)
        torch.testing.assert_close(pr_g.cpu(), pr_cpu, **CPU_TOL)
        log(f"[paths] {name}: card vs CPU, fp32 logits (batch 4): event max diff "
            f"{max_diff(ev_g.cpu(), ev_cpu):.3g}, prong {max_diff(pr_g.cpu(), pr_cpu):.3g} "
            f"(tol {CPU_TOL})")


# ---------------------------------------------------------------------------
# phase 8
# ---------------------------------------------------------------------------

def fit_datasets():
    return (InMemoryEvents(FIT_EVENTS, SEED + 5), InMemoryEvents(FIT_VAL_EVENTS, SEED + 6),
            None)


def fit_options():
    """The production option file, bfloat16 (train's -fp16), at
    ``CUT_DEPTH`` (its widths as they stand)."""
    options = Options.load(OPTION_FILE)
    options.compute_dtype = "bfloat16"
    options.update_options({k: list(v) if isinstance(v, tuple) else v
                            for k, v in CUT_DEPTH.items()})
    return options


def cut_config(dtype):
    """The option file's network at ``CUT_DEPTH``, in ``dtype``."""
    return dataclasses.replace(production_config(dtype), **CUT_DEPTH)


def assert_state_equal(got, want):
    """Two ``TrainState.state_dict()``s (host copies) equal bit for bit."""
    assert got["step"] == want["step"], (got["step"], want["step"])
    assert got["model"].keys() == want["model"].keys()
    for name, tensor in want["model"].items():
        assert torch.equal(got["model"][name], tensor), f"model tensor {name}"
    g_opt, w_opt = got["optimizer"], want["optimizer"]
    assert g_opt["param_groups"] == w_opt["param_groups"]
    assert g_opt["state"].keys() == w_opt["state"].keys() and w_opt["state"]
    for index, slots in w_opt["state"].items():
        for key, tensor in slots.items():
            assert torch.equal(g_opt["state"][index][key], tensor), f"AdamW {index} {key}"
    for key, tensor in want["norm"].items():
        assert torch.equal(got["norm"][key], tensor), f"norm {key}"
    assert torch.equal(got["generator"], want["generator"]), "generator state"


def counted(fn):
    """``fn()`` with the kernels' counts set to 0 just before it and read
    just after; returns (result, (K1, K2))."""
    torch.cuda.synchronize()
    reset_counts()
    result = fn()
    torch.cuda.synchronize()
    return result, read_counts()


def bare_step_ms(trainer, warmup=BARE_WARMUP, steps=BARE_STEPS):
    """Wall ms per step of ``trainer.train_step`` back to back over batches
    already on the card: the step the loop wraps, with no loop around it."""
    host = trainer.train_batcher.epoch(1)
    batches = [to_device(next(host), trainer.device) for _ in range(warmup + steps)]
    for batch in batches[:warmup]:
        trainer.train_step(trainer.state, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for batch in batches[warmup:]:
        trainer.train_step(trainer.state, batch)
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / steps


def checkpoint_save_s(trainer, directory):
    """Median seconds of ``CheckpointManager.save`` of the trainer's full
    state (copy to the host and ``torch.save``), and the state's MB."""
    manager = CheckpointManager(directory)
    times = []
    for step in range(SAVES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        manager.save(trainer.state, step, None)
        times.append(time.perf_counter() - t0)
    size = os.path.getsize(os.path.join(directory, f"step_{SAVES - 1}", "state.pt"))
    return statistics.median(times), size / 1e6


def check_trainer(smi):
    """Phase 8; returns K1's launches."""
    val_batches = math.ceil(FIT_VAL_EVENTS / TRAIN_BATCH)
    run_dir = tempfile.mkdtemp(prefix="chip_smoke_trainer_")
    try:
        snapshot = {}

        def snap(step, metrics):
            if step == FIT_EVAL:
                snapshot.update(to_host(trainer.state.state_dict()))

        trainer = Trainer(fit_options(), run_dir=run_dir, callbacks=[snap],
                          log_every_n_steps=FIT_LOG, datasets=fit_datasets(), verbose=False)
        assert trainer.device.type == "cuda"
        assert trainer.global_batch == TRAIN_BATCH == trainer.options.batch_size
        assert trainer.model_config.embedder == "dense"
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        result, counts = counted(lambda: trainer.fit(max_steps=FIT_STEPS,
                                                     eval_interval=FIT_EVAL))
        seconds = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        evals = FIT_STEPS // FIT_EVAL
        assert counts == (2 * (FIT_STEPS + evals * val_batches), 0), counts
        launches = counts[0]
        history = read_history(run_dir)
        losses = [v for _, v in history["train_loss"]]
        assert losses and all(math.isfinite(v) for v in losses), losses
        for key in ("val_loss", "val_epoch_AUC", "event_epoch_AUC", "prong_epoch_AUC"):
            assert math.isfinite(result[key]), (key, result[key])
        with open(os.path.join(run_dir, "checkpoints", "index.json")) as f:
            index = json.load(f)
        assert [c["step"] for c in index["checkpoints"]] == [FIT_EVAL, FIT_STEPS], index
        assert index["last"] == FIT_STEPS and snapshot["step"] == FIT_EVAL
        # the window of log step s runs from the previous log step's read to
        # s's; keep those past the first steps (logged at 1 and 2) that span
        # no validation
        eps = history["events_per_second"]
        kept = [(s, r) for (prev, _), (s, r) in zip(eps, eps[1:])
                if prev >= 2 and not any(prev <= e < s for e in range(FIT_EVAL, s, FIT_EVAL))]
        rates = [r for _, r in kept]
        log(f"[trainer] production options (num_gpu {trainer.options.num_gpu} -> 1 device), "
            f"dense, {trainer.model_config.compute_dtype}, batch {TRAIN_BATCH}: fit {FIT_STEPS} steps + {evals} "
            f"validations of {val_batches} batches in {seconds:.2f} s; last train_loss "
            f"{losses[-1]:.5f}, val_loss {result['val_loss']:.5f}, val_epoch_AUC "
            f"{result['val_epoch_AUC']:.4f}; launches K1 {counts[0]}, K2 {counts[1]}; peak "
            f"memory {peak:.2f} GiB")
        log(f"[trainer] logged events/s over windows with no validation (log steps "
            f"{[s for s, _ in kept]}): "
            f"median {statistics.median(rates):.2f}, min {min(rates):.2f}, max "
            f"{max(rates):.2f} ({len(rates)} windows; {smi})")
        bare_ms = bare_step_ms(trainer)
        log(f"[trainer] the same Trainer's step bare, batches on the card: "
            f"{bare_ms:.3f} ms/step, {1e3 * TRAIN_BATCH / bare_ms:.2f} events/s ({BARE_STEPS} "
            f"steps back to back after {BARE_WARMUP}); the loop's logged median is "
            f"{100 * statistics.median(rates) * bare_ms / (1e3 * TRAIN_BATCH):.1f}% of it ({smi})")
        save_s, save_mb = checkpoint_save_s(trainer, os.path.join(run_dir, "save_timing"))
        interval_s = trainer.options.eval_interval * bare_ms / 1e3
        log(f"[trainer] synchronous checkpoint save of {save_mb:.1f} MB: median {save_s:.3f} s "
            f"of {SAVES}; {100 * save_s / interval_s:.2f}% of the option file's eval interval "
            f"({trainer.options.eval_interval} steps, {interval_s:.1f} s at the bare step)")
        del trainer
        gc.collect()
        torch.cuda.empty_cache()

        fresh = Trainer(fit_options(), run_dir=run_dir, log_every_n_steps=FIT_LOG,
                        datasets=fit_datasets(), verbose=False)
        fresh.resume(os.path.join(run_dir, "checkpoints", f"step_{FIT_EVAL}"))
        assert_state_equal(to_host(fresh.state.state_dict()), snapshot)
        n_tensors = len(snapshot["model"]) + sum(len(v) for v in
                                                 snapshot["optimizer"]["state"].values())
        del snapshot
        _, counts = counted(lambda: fresh.fit(max_steps=RESUME_TO))
        assert counts == (2 * (RESUME_TO - FIT_EVAL + val_batches), 0), counts
        launches += counts[0]
        resumed = [v for s, v in read_history(run_dir)["train_loss"] if s == RESUME_TO]
        assert resumed and math.isfinite(resumed[-1]), resumed
        log(f"[trainer] resume(step_{FIT_EVAL}): step, {n_tensors} model and AdamW tensors, "
            f"norm and generator state equal to the step-{FIT_EVAL} snapshot bit for bit; "
            f"fit to step {RESUME_TO}: train_loss {resumed[-1]:.5f}; K1 {counts[0]}, "
            f"K2 {counts[1]}")
        del fresh
        gc.collect()
        torch.cuda.empty_cache()

        (predictions, results, _), counts = counted(
            lambda: evaluate_run(run_dir, "best", datasets=fit_datasets()))
        assert counts == (2 * val_batches, 0), counts
        launches += counts[0]
        for key in ("event_auc", "prong_auc"):
            assert math.isfinite(results[key]), (key, results[key])
        for key in ("event_probabilities", "prong_probabilities"):
            assert np.isfinite(predictions[key]).all(), key
            np.testing.assert_allclose(predictions[key].sum(-1), 1.0, atol=1e-3)
        assert predictions["event_probabilities"].shape == (FIT_VAL_EVENTS, 4)
        log(f"[trainer] evaluate_run(best) over {FIT_VAL_EVENTS} events: event AUC "
            f"{results['event_auc']:.4f}, prong AUC {results['prong_auc']:.4f}; K1 "
            f"{counts[0]}, K2 {counts[1]}")
        return launches
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)


def remat_readings(smi):
    """The dense b16 train step plain, with ``remat_cnn`` and with
    ``remat_embedder``: ms/step and peak memory, reported only."""
    options = fit_options()
    ds = InMemoryEvents(TRAIN_BATCH * (REMAT_WARMUP + REMAT_STEPS), SEED + 7)
    batches = [to_device(b, "cuda") for b in Batcher(ds, batch_size=TRAIN_BATCH).epoch(0)]
    readings = []
    for flags in ({}, {"remat_cnn": True}, {"remat_embedder": True}):
        cfg = dataclasses.replace(cut_config("bfloat16"), **flags)
        model = TransformerCVN(cfg, generator=torch.Generator().manual_seed(SEED)).cuda()
        state = create_train_state(model, options, ds.norm(), len(batches), seed=SEED)
        step = make_train_step(model, options)
        for batch in batches[:REMAT_WARMUP]:
            step(state, batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for batch in batches[REMAT_WARMUP:]:
            metrics = step(state, batch)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / REMAT_STEPS
        peak = torch.cuda.max_memory_allocated() / 2**30
        assert math.isfinite(float(metrics["train_loss"]))
        name = "+".join(flags) or "plain"
        readings.append((name, ms, peak))
        del model, state, step, metrics
        gc.collect()
        torch.cuda.empty_cache()
    log("[remat] dense b16 train step, " + "; ".join(
        f"{name} {ms:.2f} ms/step, peak {peak:.2f} GiB" for name, ms, peak in readings)
        + f" ({REMAT_STEPS} steps after {REMAT_WARMUP}; {smi})")


# ---------------------------------------------------------------------------
# phase 9
# ---------------------------------------------------------------------------

def state_digest(model):
    """sha256 of every parameter and buffer's bytes, in ``state_dict`` order."""
    digest = hashlib.sha256()
    for name, tensor in model.state_dict().items():
        digest.update(name.encode())
        digest.update(tensor.detach().cpu().contiguous().view(torch.uint8).numpy().tobytes())
    return digest.hexdigest()


def data_parallel_rank(rank, ranks, batch, backend, rendezvous, log_dir, out_path):
    """One rank of phase 9 (a process of its own): trains, validates and
    predicts as the data-parallel Trainer does, times its step with sync-BN
    and without, and writes what the parent checks to ``out_path``."""
    import torch.distributed as dist

    device = torch.device("cuda", rank if backend == "nccl" else 0)
    torch.cuda.set_device(device)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group(backend, init_method=f"file://{rendezvous}",
                            world_size=ranks, rank=rank,
                            timeout=datetime.timedelta(seconds=DP_TIMEOUT_S))
    dist.all_reduce(torch.zeros(1, device=device))   # the ranks meet once, in step
    try:
        options = fit_options()
        options.batch_size = batch
        trainer = Trainer(options, log_dir=log_dir, name="dp", log_every_n_steps=1,
                          device=device, verbose=False,
                          datasets=(InMemoryEvents(DP_EVENTS, SEED + 8),
                                    InMemoryEvents(DP_VAL_EVENTS, SEED + 9), None))
        assert trainer.num_shards == ranks and trainer.global_batch == ranks * batch
        torch.cuda.reset_peak_memory_stats(device)
        result, fit_counts = counted(lambda: trainer.fit(max_steps=DP_STEPS,
                                                         eval_interval=DP_STEPS))
        peak = torch.cuda.max_memory_allocated(device) / 2**30
        digest = state_digest(trainer.state.model)
        predictions, predict_counts = counted(lambda: trainer.predict_split("validation"))
        losses = ([v for _, v in read_history(trainer.run_dir)["train_loss"]]
                  if trainer.run_dir else [])
        bare_ms = bare_step_ms(trainer, DP_BARE_WARMUP, DP_BARE_STEPS)
        # the same step with sync-BN off: the running statistics averaged
        # in the step's one all-reduce instead of one all-reduce a layer
        options.sync_batch_norm = False
        trainer.train_step = make_train_step(sync_batch_norm(trainer.state.model, None),
                                             options)
        unsynced_ms = bare_step_ms(trainer, DP_BARE_WARMUP, DP_BARE_STEPS)
        ev = predictions["event_probabilities"]
        out = dict(
            rank=rank, device=str(device), run_dir=trainer.run_dir, state=digest,
            predictions=hashlib.sha256(ev.tobytes() + predictions[
                "prong_probabilities"].tobytes()).hexdigest(),
            rows=ev.shape[0], finite=bool(np.isfinite(ev).all()),
            targets_in_order=bool(np.array_equal(
                predictions["event_targets"], trainer.validation_dataset.event_targets)),
            fit_counts=fit_counts, predict_counts=predict_counts, losses=losses,
            val_loss=result["val_loss"], val_auc=result["val_epoch_AUC"],
            ms_per_step=bare_ms, unsynced_ms_per_step=unsynced_ms, peak_gib=peak)
    finally:
        dist.destroy_process_group()
    with open(out_path, "w") as f:
        json.dump(out, f)


def check_data_parallel(smi, ranks=DP_RANKS, batch=DP_BATCH):
    """Phase 9: ``ranks`` processes of ``batch`` events a step; returns K1's
    launches over the ranks."""
    backend = "nccl" if torch.cuda.device_count() >= ranks else "gloo"
    where = (f"nccl, one card each ({torch.cuda.device_count()} cards)" if backend == "nccl"
             else "gloo with CUDA tensors, every rank on the one card")
    log(f"[dp] {ranks} ranks over {where}")
    work = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    here = os.path.dirname(os.path.abspath(__file__))
    try:
        outs = [os.path.join(work, f"rank{r}.json") for r in range(ranks)]
        procs = [subprocess.Popen(
            [sys.executable, "-c", "import sys, chip_smoke; chip_smoke.data_parallel_rank("
             "*map(int, sys.argv[1:4]), *sys.argv[4:])",
             str(r), str(ranks), str(batch), backend, os.path.join(work, "rendezvous"),
             work, outs[r]],
            cwd=here, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env={**os.environ, "LOCAL_RANK": str(r)}) for r in range(ranks)]
        t0 = time.perf_counter()
        try:
            texts = [p.communicate(timeout=DP_TIMEOUT_S)[0] for p in procs]
        finally:
            for p in procs:
                p.kill()
                p.wait()
        seconds = time.perf_counter() - t0
        for r, (p, text) in enumerate(zip(procs, texts)):
            if p.returncode != 0:
                raise RuntimeError(f"data-parallel rank {r} exited {p.returncode}:\n"
                                   + text[-6000:])
        results = []
        for path in outs:
            with open(path) as f:
                results.append(json.load(f))
        val_batches = math.ceil(DP_VAL_EVENTS / (ranks * batch))
        for r in results:
            assert r["fit_counts"] == [2 * (DP_STEPS + val_batches), 0], r["fit_counts"]
            assert r["predict_counts"] == [2 * val_batches, 0], r["predict_counts"]
            assert r["rows"] == DP_VAL_EVENTS and r["finite"] and r["targets_in_order"], r
            assert math.isfinite(r["val_loss"]) and math.isfinite(r["val_auc"]), r
        assert len({r["state"] for r in results}) == 1, "the ranks' states differ"
        assert len({r["predictions"] for r in results}) == 1, "the ranks' predictions differ"
        assert results[0]["run_dir"] and not any(r["run_dir"] for r in results[1:])
        losses = results[0]["losses"]
        assert len(losses) == DP_STEPS and all(math.isfinite(v) for v in losses), losses
        log(f"[dp] {ranks} ranks x batch {batch} ({backend}): fit {DP_STEPS} steps + 1 "
            f"validation of {val_batches} batches, predict_split of {DP_VAL_EVENTS} events, "
            f"in {seconds:.1f} s of the processes' life; states equal bit for bit, "
            f"predictions equal ({DP_VAL_EVENTS} rows in order); train_loss "
            f"{[round(v, 5) for v in losses]}, val_loss {results[0]['val_loss']:.5f}; K1 per "
            f"rank {results[0]['fit_counts'][0]} fit + {results[0]['predict_counts'][0]} predict, "
            f"K2 0")
        for r in results:
            log(f"[dp] rank {r['rank']} on {r['device']}: {r['ms_per_step']:.2f} ms/step, "
                f"{r['unsynced_ms_per_step']:.2f} with sync-BN off ({DP_BARE_STEPS} steps "
                f"bare after {DP_BARE_WARMUP}); {batch * ranks / r['ms_per_step'] * 1e3:.2f} "
                f"events/s over the ranks; peak memory {r['peak_gib']:.2f} GiB ({smi})")
        return sum(r["fit_counts"][0] + r["predict_counts"][0] for r in results)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def check_world_of_one(graph=False):
    """The Trainer in a world of one over ``nccl`` against the Trainer with
    no process group: the states after the same steps equal bit for bit
    (cuDNN set to deterministic algorithms for both runs).  ``graph``: both
    ``Trainer(graph=True)`` at ``steps_per_dispatch`` ``ONE_RANK_GRAPH_K``,
    ``ONE_RANK_GRAPH_STEPS`` steps.  Returns K1's launches."""
    import torch.distributed as dist

    work = tempfile.mkdtemp(prefix="chip_smoke_one_")
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    steps = ONE_RANK_GRAPH_STEPS if graph else ONE_RANK_STEPS
    try:
        digests, launches = [], 0
        for grouped in (False, True):
            if grouped:
                dist.init_process_group("nccl", init_method=f"file://{work}/rendezvous",
                                        world_size=1, rank=0)
            try:
                options = fit_options()
                if graph:
                    options.steps_per_dispatch = ONE_RANK_GRAPH_K
                trainer = Trainer(options, debug=True, verbose=False, datasets=fit_datasets(),
                                  graph=graph)
                assert trainer.num_shards == 1
                _, counts = counted(lambda: trainer.fit(max_steps=steps, eval_interval=steps))
                launches += counts[0]
                digests.append(state_digest(trainer.state.model))
                del trainer
                gc.collect()
                torch.cuda.empty_cache()
            finally:
                if grouped:
                    dist.destroy_process_group()
        what = (f"Trainer(graph=True), {ONE_RANK_GRAPH_K} steps a replay" if graph
                else "Trainer")
        assert digests[0] == digests[1], f"a world of one over nccl changed the {what}'s state"
        log(f"[{'graph-dp' if graph else 'dp'}] world of one over nccl, {what}: state after "
            f"{steps} steps equal bit for bit to the same Trainer's with no process group; "
            f"K1 {launches}")
        return launches
    finally:
        torch.backends.cudnn.deterministic = deterministic
        shutil.rmtree(work, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 10
# ---------------------------------------------------------------------------

def free_memory():
    gc.collect()
    torch.cuda.empty_cache()


def train_reading(cfg, batch_size, warmup, steps, seed):
    """``steps`` train steps of ``cfg``'s network at ``batch_size`` after
    ``warmup``, the option file's optimizer; returns (ms/step, peak GiB of
    the timed steps, K1 launches), with K1 asserted twice a step and K2
    never, and a finite loss and gradient norm."""
    options = fit_options()
    ds = InMemoryEvents(batch_size * (warmup + steps), seed)
    batches = [to_device(b, "cuda") for b in Batcher(ds, batch_size=batch_size).epoch(0)]
    model = TransformerCVN(cfg, generator=torch.Generator().manual_seed(SEED)).cuda()
    state = create_train_state(model, options, ds.norm(), len(batches), seed=SEED)
    step = make_train_step(model, options)
    torch.cuda.synchronize()
    reset_counts()
    for batch in batches[:warmup]:
        step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for batch in batches[warmup:]:
        metrics = step(state, batch)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / steps
    counts = read_counts()
    assert counts == (2 * (warmup + steps), 0), (cfg.embedder, counts)
    loss, grad_norm = float(metrics["train_loss"]), float(metrics["grad_norm"])
    assert math.isfinite(loss) and math.isfinite(grad_norm), (cfg.embedder, loss, grad_norm)
    peak = torch.cuda.max_memory_allocated() / 2**30
    del model, state, step, batches, metrics
    free_memory()
    return ms, peak, counts[0]


def check_sdxl_chunks():
    """The sdxl network in float32 (TF32 off), chunked against unchunked, at
    a small batch: logits and every parameter's gradient of a fixed
    projection of them; returns K1's launches."""
    cfg = family_config("sdxl", compute_dtype="float32", dropout=0.0, pixel_noise_std=0.0)
    model = TransformerCVN(cfg, generator=torch.Generator().manual_seed(SEED)).cuda().train()
    ds = InMemoryEvents(SDXL_CHECK_BATCH, SEED + 12)
    batch = to_device(Batcher(ds, batch_size=SDXL_CHECK_BATCH).build_batch(
        np.arange(SDXL_CHECK_BATCH)), "cuda")
    norm = to_device(ds.norm(), "cuda")
    P = batch["slot_batch"].shape[0]

    def run(chunk):
        model.cfg = dataclasses.replace(cfg, embedder_chunk=chunk)
        model.zero_grad(set_to_none=True)
        ev, pr = model(batch, norm)
        weights = [torch.linspace(-1.0, 1.0, t.numel(), device="cuda").reshape(t.shape)
                   for t in (ev, pr)]
        (ev * weights[0]).sum().add((pr * weights[1]).sum()).backward()
        return (ev.detach(), pr.detach()), {n: p.grad.clone() for n, p in
                                            model.named_parameters() if p.grad is not None}

    (full, full_grads), counts = counted(lambda: run(0))
    (chunked, chunked_grads), chunked_counts = counted(lambda: run(SDXL_CHECK_CHUNK))
    assert counts == chunked_counts == (2, 0), (counts, chunked_counts)
    for got, want in zip(chunked, full):
        torch.testing.assert_close(got, want, **CHUNK_TOL)
    assert chunked_grads.keys() == full_grads.keys() and len(full_grads) > 100
    largest = max(g.abs().max().item() for g in full_grads.values())
    worst = 0.0
    for name, want in full_grads.items():
        scale = want.abs().max().item()
        diff = (chunked_grads[name] - want).abs().max().item()
        bound = CHUNK_GRAD_SHARE * scale + CHUNK_GRAD_FLOOR * largest
        assert diff <= bound, (name, diff, scale, largest)
        worst = max(worst, diff / bound)
    log(f"[sdxl] float32, batch {SDXL_CHECK_BATCH} ({P} prong slots): chunks of "
        f"{SDXL_CHECK_CHUNK} against the full bank: logits max diff "
        f"{max(max_diff(g, w) for g, w in zip(chunked, full)):.3g} (tol {CHUNK_TOL}), "
        f"{len(full_grads)} gradients within {CHUNK_GRAD_SHARE} of the tensor's largest "
        f"element + {CHUNK_GRAD_FLOOR} of the network's ({largest:.3g}); the worst used "
        f"{worst:.1%} of its bound")
    del model, full_grads, chunked_grads
    free_memory()
    return counts[0] + chunked_counts[0]


def check_families(smi):
    """Phase 10; returns K1's launches."""
    launches = 0
    sdxl = family_config("sdxl", embedder_chunk=SDXL_CHUNK)
    _, counts = check_serving("sdxl", sdxl, SDXL_SERVE_EVENTS, passes=1)
    launches += int(counts[0])
    free_memory()
    ms, peak, k1 = train_reading(sdxl, TRAIN_BATCH, SDXL_WARMUP, SDXL_STEPS, SEED + 10)
    launches += k1
    log(f"[sdxl] train b{TRAIN_BATCH}, embedder_chunk {SDXL_CHUNK}: {SDXL_STEPS} steps after "
        f"{SDXL_WARMUP}, {ms:.2f} ms/step, {1e3 * TRAIN_BATCH / ms:.2f} events/s, peak "
        f"memory {peak:.2f} GiB; K1 {k1} ({smi})")
    readings = []
    for name, cfg, batch_size in (
            (f"embedder_chunk {SDXL_CHUNK} + save_spatial {SDXL_SAVE_SPATIAL}",
             dataclasses.replace(sdxl, embedder_chunk_save_spatial=SDXL_SAVE_SPATIAL),
             TRAIN_BATCH),
            ("unchunked", dataclasses.replace(sdxl, embedder_chunk=0), SDXL_UNCHUNKED_BATCH)):
        ms, peak, k1 = train_reading(cfg, batch_size, SDXL_READING_WARMUP,
                                     SDXL_READING_STEPS, SEED + 11)
        launches += k1
        readings.append(f"{name} b{batch_size}: {ms:.2f} ms/step, "
                        f"{1e3 * batch_size / ms:.2f} events/s, peak {peak:.2f} GiB")
    log(f"[sdxl] train readings ({SDXL_READING_STEPS} steps after {SDXL_READING_WARMUP}): "
        + "; ".join(readings) + f" ({smi})")
    launches += check_sdxl_chunks()
    for embedder in OTHER_FAMILIES:
        _, counts = check_serving(embedder, sizes=((TRAIN_BATCH, FAMILY_SERVE_EVENTS),),
                                  passes=1)
        launches += int(counts[0])
        free_memory()
        ms, peak, k1 = train_reading(family_config(embedder), TRAIN_BATCH, FAMILY_WARMUP,
                                     FAMILY_STEPS, SEED + 13)
        launches += k1
        log(f"[{embedder}] train b{TRAIN_BATCH}: {FAMILY_STEPS} steps after {FAMILY_WARMUP}, "
            f"{ms:.2f} ms/step, {1e3 * TRAIN_BATCH / ms:.2f} events/s, peak memory "
            f"{peak:.2f} GiB; K1 {k1} ({smi})")
    return launches


# ---------------------------------------------------------------------------
# phase 11
# ---------------------------------------------------------------------------

OUTPUT_KINDS = {"pid": ("probabilities",) * 2, "embeddings": ("hidden",) * 2,
                "combined": ("probabilities",) * 2 + ("hidden",) * 2}


def event_pixel_maps(ds, index, max_prongs):
    """One event's raw pixel counts as the exported graphs take them:
    ``[1 + max_prongs, C, H, W]`` float32 on the card (the event image, then
    the prong images padded with zeros), and its prong count."""
    t = to_device(Batcher(ds, batch_size=1).build_batch(np.array([index])), "cpu")
    images = [densify_images_plain(t[f"{key}_xy"], t[f"{key}_vals"], t[f"{key}_owner"],
                                   n, H, W)
              for key, n in (("event", 1), ("prong", t["slot_batch"].shape[0]))]
    num_prongs = int(t["slot_mask"].sum())
    pixels = torch.zeros((1 + max_prongs, H, W, C))
    pixels[0] = images[0][0]
    pixels[1:1 + num_prongs] = images[1][:num_prongs]
    return pixels.permute(0, 3, 1, 2).contiguous().cuda(), num_prongs


def check_export(model, norm, ds, smi, out_dir):
    """``export_model`` on the card into ``out_dir``; every artifact against
    the eager graph."""
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    paths = export_model(model, norm, out_dir, prong_buckets=EXPORT_LADDER,
                         bench_buckets=True)
    seconds = time.perf_counter() - t0
    assert read_counts() == (0, 0), read_counts()
    with open(os.path.join(out_dir, "transformercvn_export_meta.json")) as f:
        meta = json.load(f)
    rungs = [int(p) for p in meta["prong_buckets"]]
    device = next(model.parameters()).device
    assert rungs == [4, 20] and meta["platforms"] == [device.type], meta
    sizes = sum(os.path.getsize(p) for p in paths.values()) / 1e6
    log(f"[export] {len(paths)} artifacts ({sizes:.1f} MB) for rungs {rungs} in "
        f"{seconds:.2f} s, bucket_ms timed included; pid bucket_ms per event "
        + ", ".join(f"P={p}: {meta['bucket_ms'][str(p)]:.4f}" for p in rungs)
        + f" ({smi})")
    # an event with at most 4 prongs, so every rung serves it
    index = next(i for i in range(len(ds)) if int((ds.prong_targets[i] >= 0).sum()) <= 4)
    full, num_prongs = event_pixel_maps(ds, index, model.cfg.max_prongs)
    n = torch.tensor(num_prongs, dtype=torch.int32, device=full.device)
    worst = 0.0
    for key, path in paths.items():
        capacity = int(key.rsplit("_p", 1)[1]) if "_p" in key else model.cfg.max_prongs
        variant = key.split("_")[0]
        pixels = full[:1 + capacity]
        t0 = time.perf_counter()
        loaded = load_exported(path)
        load_s = time.perf_counter() - t0
        got = loaded(pixels, n)
        with torch.inference_mode():
            want = build_inference_fn(with_max_prongs(model, capacity), variant,
                                      norm)(pixels, n)
        diffs = []
        for g, w, kind in zip(got, want, OUTPUT_KINDS[variant]):
            assert g.shape == w.shape and torch.isfinite(g).all(), (key, g.shape)
            bound = (EXPORT_PROB_TOL if kind == "probabilities"
                     else EXPORT_HIDDEN_SHARE * w.float().abs().max().item())
            diff = max_diff(g, w)
            assert diff <= bound, (key, diff, bound)
            diffs.append(diff)
            worst = max(worst, diff / bound)
        log(f"[export] {key}: loaded in {load_s:.2f} s; against the eager graph on an "
            f"event of {num_prongs} prongs, max diffs {[f'{d:.3g}' for d in diffs]}")
    log(f"[export] every artifact within its bound (probabilities {EXPORT_PROB_TOL}, "
        f"hidden {EXPORT_HIDDEN_SHARE} of the largest); the worst used {worst:.1%}")
    check_captured_rungs(paths, meta, model, ds, smi)
    return seconds, meta["bucket_ms"]


def captured_equals(graph, eager, events, what):
    """``graph`` (an ``EventGraph``) against ``eager`` on each of ``events``
    (pixels, num_prongs), bit for bit: the first captures, the others
    replay with other events copied in."""
    for pixels, n in events:
        got, want = graph(pixels, n), eager(pixels, n)
        assert len(got) == len(want), what
        for g, w in zip(got, want):
            assert torch.equal(g, w), (what, int(n), max_diff(g, w))
    assert len(graph.graphs.graphs) == 1, what


def serving_rows(ds, max_prongs, capacity, count):
    """``count`` events of ``ds`` as one rung of ``capacity`` takes them:
    (pixels [1+capacity, C, H, W] on the card, 0-d int32 num_prongs)."""
    events = []
    for index in range(len(ds)):
        if len(events) == count:
            break
        if int((ds.prong_targets[index] >= 0).sum()) <= capacity:
            full, n = event_pixel_maps(ds, index, max_prongs)
            events.append((full[:1 + capacity],
                           torch.tensor(n, dtype=torch.int32, device=full.device)))
    return events


def check_captured_rungs(paths, meta, model, ds, smi):
    """Each exported pid rung captured as one CUDA graph
    (``load_exported(..., graph=True)``) against its program, bit for bit
    on three real events, and the meta's ``graph_bucket_ms`` beside
    ``bucket_ms``; then the option file's full-depth network's rungs timed
    eager and captured (``export._time_bucket_ms``), equal bit for bit."""
    graph_ms, eager_ms = meta["graph_bucket_ms"], meta["bucket_ms"]
    max_prongs = model.cfg.max_prongs
    for key, path in paths.items():
        if not key.startswith("pid"):
            continue
        capacity = int(key.rsplit("_p", 1)[1]) if "_p" in key else max_prongs
        captured_equals(load_exported(path, graph=True), load_exported(path),
                        serving_rows(ds, max_prongs, capacity, 3), key)
    log(f"[export] pid rungs captured as one CUDA graph each (load_exported graph=True), "
        f"bit-equal to their programs on 3 events; per event: "
        + ", ".join(f"P={p}: eager {eager_ms[p]:.4f} ms, graph {graph_ms[p]:.4f} ms "
                    f"({eager_ms[p] / graph_ms[p]:.2f}x)" for p in sorted(graph_ms, key=int))
        + f" (depth {CUT_DEPTH}; {smi})")
    full = TransformerCVN(production_config("bfloat16"),
                          generator=torch.Generator().manual_seed(SEED + 21)).cuda().eval()
    norm = ds.norm()
    readings = []
    for capacity in FULL_DEPTH_RUNGS:
        module = build_inference_fn(with_max_prongs(full, capacity), "pid", norm)
        eager = torch.inference_mode()(module)
        graph = EventGraph(eager, f"full-depth rung {capacity}")
        events = serving_rows(ds, max_prongs, capacity, 2)
        captured_equals(graph, eager, events, f"full depth P={capacity}")
        readings.append((capacity, _time_bucket_ms(eager, *events[0]),
                         _time_bucket_ms(graph, *events[0])))
    log("[export] the option file's full-depth pid rungs (InferenceGraph, bf16), eager "
        "against one CUDA graph (EventGraph), bit-equal on 2 events; per event: "
        + ", ".join(f"P={p}: eager {e:.4f} ms, graph {g:.4f} ms ({e / g:.2f}x)"
                    for p, e, g in readings) + f" (export._time_bucket_ms; {smi})")
    del full
    free_memory()


def timed_predict(model, ds, norm, **kwargs):
    """One ``predict_split`` pass at batch 16 with the counts reset before
    it: (output, events/s, K1 launches), K1 asserted twice a batch."""
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    out = predict_split(model, ds, norm, TRAIN_BATCH, "cuda", **kwargs)
    torch.cuda.synchronize()
    rate = len(ds) / (time.perf_counter() - t0)
    counts = read_counts()
    assert counts == (2 * math.ceil(len(ds) / TRAIN_BATCH), 0), counts
    for key in ("event_probabilities", "prong_probabilities"):
        assert np.isfinite(out[key]).all(), key
    return out, rate, counts[0]


def prob_diffs(a, b):
    """Largest probability difference and argmax agreement, events and prongs."""
    return {k: ((np.abs(a[f"{k}_probabilities"] - b[f"{k}_probabilities"]).max()),
                float((a[f"{k}_probabilities"].argmax(-1)
                       == b[f"{k}_probabilities"].argmax(-1)).mean()))
            for k in ("event", "prong")}


def check_int8_route(model, scales, batch, norm):
    """One quantized batch in which every int8 convolution's operands also
    go through both int32 routes, ``_int_mm`` on the card and the plain
    float64 one, which must agree int32 for int32; returns the number of
    convolutions checked, of distinct shapes, and K1's launches in the
    forward (its two densify calls)."""
    int8_conv = quant.int8_conv
    shapes = set()

    def checked(x, weight, bias, act_scale, stride=1, padding=0, out_dtype=None):
        qx = quant.quantize_activation(x, act_scale)
        qw, _ = quant.quantize_weight(weight)
        got = quant.conv_int32_cuda(qx, qw, stride, padding)
        want = quant.conv_int32_plain(qx, qw, stride, padding)
        assert got.dtype == want.dtype == torch.int32 and torch.equal(got, want), (
            qx.shape, qw.shape, stride, padding)
        shapes.add((tuple(qx.shape), tuple(qw.shape), str(stride), str(padding)))
        return int8_conv(x, weight, bias, act_scale, stride, padding, out_dtype)

    calls = quant.conv_int32_cuda.launches
    quant.int8_conv = checked
    reset_counts()
    try:
        with quant.quantized_convs(model, scales), torch.inference_mode():
            model(batch, norm)
        torch.cuda.synchronize()
    finally:
        quant.int8_conv = int8_conv
    assert read_counts() == (2, 0), read_counts()
    # each conv once in the check and once in the forward
    assert quant.conv_int32_cuda.launches - calls == 2 * len(scales), (
        quant.conv_int32_cuda.launches - calls, len(scales))
    return len(scales), len(shapes), read_counts()[0]


def graph_predict(model, ds, norm, scales=None):
    """``predict_split(graph=True)`` at batch 16, inside the int8 context of
    ``scales`` when given, with the counts reset before it: (output,
    events/s, K1 launches, ``_int_mm`` route launches, graphs captured in
    the pass).  K1 is asserted twice a forward: a batch's replay, and the
    warm-up before each capture."""
    def graphs():
        return sum(len(step.graphs.graphs)
                   for step in model.__dict__.get("_graph_predict_steps", {}).values())

    before = graphs()
    mm = quant.conv_int32_cuda.launches
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    with (quant.quantized_convs(model, scales) if scales else contextlib.nullcontext()):
        out = predict_split(model, ds, norm, TRAIN_BATCH, "cuda", graph=True)
    torch.cuda.synchronize()
    rate = len(ds) / (time.perf_counter() - t0)
    captured = graphs() - before
    counts = read_counts()
    assert counts == (2 * (math.ceil(len(ds) / TRAIN_BATCH) + captured), 0), (counts, captured)
    for key in ("event_probabilities", "prong_probabilities"):
        assert np.isfinite(out[key]).all(), key
    return out, rate, counts[0], quant.conv_int32_cuda.launches - mm, captured


def check_int8_graphs(model, ds, norm, scales, int8_eager):
    """The int8 ``predict_split`` at batch 16 as CUDA graphs, beside the bf16
    graphs, in turns after a capturing pass of each: the int8 graphs equal
    the eager int8 pass bit for bit, and the ``_int_mm`` route launches
    once a quantized conv a forward (each replay's, and each capture's
    warm-up).  Returns {int8?: [events/s, events/s]} and K1's launches."""
    batches = math.ceil(len(ds) / TRAIN_BATCH)
    launches = 0
    rates = {True: [], False: []}
    for quantized in (True, False, True, False, False, True):
        out, rate, k1, mm, captured = graph_predict(model, ds, norm,
                                                    scales if quantized else None)
        launches += k1
        assert mm == (len(scales) * (batches + captured) if quantized else 0), (mm, captured)
        if quantized:
            for key, value in int8_eager.items():
                np.testing.assert_array_equal(out[key], value, err_msg=key)
        if len(rates[quantized]) < 2 and not captured:
            rates[quantized].append(rate)
        elif captured:
            log(f"[int8] {'int8' if quantized else 'bf16'} graphs: {captured} shapes captured "
                f"in the first pass ({rate:.1f} events/s with the captures)")
    log(f"[int8] graph=True inside the context: every pass bit-equal to the eager int8 "
        f"pass; _int_mm launched {len(scales)} times a replay (one a quantized conv), K1 "
        f"twice a forward")
    model.__dict__.pop("_graph_predict_steps", None)      # the graphs' pools back
    free_memory()
    return rates, launches


def check_serving_variants(smi, export_dir):
    """Phase 11, its programs exported into ``export_dir``; returns K1's
    launches and what phase 13 packages: the model (in eval mode), its norm
    statistics and the events.  The network is the option file's at
    ``CUT_DEPTH``."""
    model = TransformerCVN(cut_config("bfloat16"),
                           generator=torch.Generator().manual_seed(SEED)).cuda()
    ds = InMemoryEvents(VARIANT_EVENTS, SEED + 14)
    norm = ds.norm()
    norm_t = to_device(norm, "cuda")
    batches = [to_device(b, "cuda") for b in Batcher(ds, batch_size=TRAIN_BATCH).epoch(0)]
    launches = 0
    reset_counts()
    with torch.no_grad():              # BatchNorm statistics away from their starts
        for batch in batches[:STAT_FORWARDS]:
            model(batch, norm_t)
    launches += read_counts()[0]
    model.eval()

    export_s, bucket_ms = check_export(model, norm, ds, smi, export_dir)

    # fold: raw, folded, folded, raw after a warm-up pass of each
    for fold in (False, True):
        _, _, k1 = timed_predict(model, ds, norm, fold_eval_bn=fold)
        launches += k1
    rates = {False: [], True: []}
    outs = {}
    for fold in (False, True, True, False):
        outs[fold], rate, k1 = timed_predict(model, ds, norm, fold_eval_bn=fold)
        rates[fold].append(rate)
        launches += k1
    fold_diff = prob_diffs(outs[True], outs[False])
    for k, (diff, _) in fold_diff.items():
        largest = outs[False][f"{k}_probabilities"].max()
        assert diff <= FOLD_SHARE * largest, (k, diff, largest)
    # what a folded pass spends on its folded copy, once a call
    copy_s = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        folded_copy(model)
        torch.cuda.synchronize()
        copy_s.append(time.perf_counter() - t0)
    copy_s = statistics.median(copy_s)
    bare = [VARIANT_EVENTS / (VARIANT_EVENTS / r - copy_s) for r in rates[True]]
    log(f"[fold] predict_split b{TRAIN_BATCH} over {VARIANT_EVENTS} events, in turns: raw "
        f"{rates[False][0]:.1f}, {rates[False][1]:.1f} events/s; folded {rates[True][0]:.1f}, "
        f"{rates[True][1]:.1f} events/s, of which the folded copy {copy_s:.4f} s a call "
        f"(median of 3), so {bare[0]:.1f}, {bare[1]:.1f} events/s without it; folded "
        f"against raw: event max diff {fold_diff['event'][0]:.3g} (argmax "
        f"{fold_diff['event'][1]:.4f}), prong {fold_diff['prong'][0]:.3g} (argmax "
        f"{fold_diff['prong'][1]:.4f}), bound {FOLD_SHARE} of the largest ({smi})")

    # int8
    reset_counts()
    t0 = time.perf_counter()
    scales = quant.calibrate_activation_scales(model, batches[:CALIBRATION_BATCHES], norm)
    torch.cuda.synchronize()
    calibrate_s = time.perf_counter() - t0
    assert read_counts() == (2 * CALIBRATION_BATCHES, 0), read_counts()
    launches += read_counts()[0]
    convs = sum(isinstance(m, torch.nn.Conv2d) for m in model.modules())
    assert len(scales) == convs, (len(scales), convs)
    checked, distinct, k1 = check_int8_route(model, scales, batches[0], norm_t)
    launches += k1
    int8_rates, bf16_rates = [], []
    calls = quant.conv_int32_cuda.launches
    with quant.quantized_convs(model, scales):
        int8_out, _, k1 = timed_predict(model, ds, norm)      # warm-up
        launches += k1
    for quantized in (True, False, False, True):
        if quantized:
            with quant.quantized_convs(model, scales):
                int8_out, rate, k1 = timed_predict(model, ds, norm)
            int8_rates.append(rate)
        else:
            bf16_out, rate, k1 = timed_predict(model, ds, norm)
            bf16_rates.append(rate)
        launches += k1
    num_batches = math.ceil(VARIANT_EVENTS / TRAIN_BATCH)
    assert quant.conv_int32_cuda.launches - calls == 3 * num_batches * len(scales)
    int8_diff = prob_diffs(int8_out, bf16_out)
    graph_rates, k1 = check_int8_graphs(model, ds, norm, scales, int8_out)
    launches += k1
    log(f"[int8] {len(scales)} convs calibrated on {CALIBRATION_BATCHES} batches in "
        f"{calibrate_s:.2f} s; one quantized batch: {checked} int8 convolutions ({distinct} "
        f"shapes) with _int_mm sums equal to the plain float64 route's, int32 for int32")
    log(f"[int8] predict_split b{TRAIN_BATCH} over {VARIANT_EVENTS} events, in turns: int8 "
        f"{int8_rates[0]:.1f}, {int8_rates[1]:.1f} events/s; bf16 {bf16_rates[0]:.1f}, "
        f"{bf16_rates[1]:.1f} events/s; int8 against bf16: event argmax agreement "
        f"{int8_diff['event'][1]:.4f}, max prob diff {int8_diff['event'][0]:.4g}; prong "
        f"argmax {int8_diff['prong'][1]:.4f}, max diff {int8_diff['prong'][0]:.4g} ({smi})")
    log(f"[int8] predict_split b{TRAIN_BATCH} as CUDA graphs (graph=True), in turns: int8 "
        f"{graph_rates[True][0]:.1f}, {graph_rates[True][1]:.1f} events/s; bf16 "
        f"{graph_rates[False][0]:.1f}, {graph_rates[False][1]:.1f} events/s ({smi})")
    log(f"[serving variants] export {export_s:.2f} s, bucket_ms {bucket_ms}; K1 {launches} "
        f"in phase 11")
    del batches
    free_memory()
    return launches, (model, norm, ds)


# ---------------------------------------------------------------------------
# phase 12
# ---------------------------------------------------------------------------

def median_ms(fn, repeats=HOST_REPEATS):
    """Median host milliseconds of ``fn()`` over ``repeats`` calls (after one)."""
    fn()
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def check_optimizers(smi):
    """Each optimizer's b16 step on the option file's dense network from the
    same starting weights; lamb and lars resumed in a Trainer bit for bit.
    Returns K1's launches."""
    model = TransformerCVN(cut_config("bfloat16"),
                           generator=torch.Generator().manual_seed(SEED)).cuda()
    start = {k: v.clone() for k, v in model.state_dict().items()}
    ds = InMemoryEvents(TRAIN_BATCH * (OPT_WARMUP + OPT_STEPS), SEED + 20)
    batches = [to_device(b, "cuda") for b in Batcher(ds, batch_size=TRAIN_BATCH).epoch(0)]
    launches, readings = 0, []
    for name in OPTIMIZERS:
        options = fit_options()
        options.optimizer = name
        model.load_state_dict(start)
        state = create_train_state(model, options, ds.norm(), len(batches), seed=SEED)
        step = make_train_step(model, options)
        torch.cuda.synchronize()
        reset_counts()
        for batch in batches[:OPT_WARMUP]:
            step(state, batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for batch in batches[OPT_WARMUP:]:
            metrics = step(state, batch)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / OPT_STEPS
        counts = read_counts()
        assert counts == (2 * len(batches), 0), (name, counts)
        launches += counts[0]
        loss = float(metrics["train_loss"])
        assert math.isfinite(loss), (name, loss)
        moved = sum(not torch.equal(p, start[n]) for n, p in model.named_parameters())
        assert moved > 0, name
        readings.append(f"{name} ({type(state.optimizer).__name__}) {ms:.2f} ms, "
                        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, {moved} of "
                        f"{len(list(model.parameters()))} parameters moved")
        del state, step, metrics
        free_memory()
    log(f"[optimizers] dense b{TRAIN_BATCH}, {OPT_STEPS} steps after {OPT_WARMUP} from the "
        f"same weights, ms/step and peak: " + "; ".join(readings) + f" ({smi})")
    del model, start, batches
    free_memory()

    for name in RESUME_OPTIMIZERS:
        run_dir = tempfile.mkdtemp(prefix=f"chip_smoke_{name}_")
        try:
            options = fit_options()
            options.optimizer = name
            straight = Trainer(options, run_dir=run_dir, log_every_n_steps=FIT_LOG,
                               datasets=fit_datasets(), verbose=False)
            _, counts = counted(lambda: straight.fit(max_steps=RESUME_FIT,
                                                     eval_interval=RESUME_AT))
            launches += counts[0]
            want = to_host(straight.state.state_dict())
            assert want["step"] == RESUME_FIT and type(straight.state.optimizer).__name__ != \
                "AdamW", type(straight.state.optimizer)
            del straight
            free_memory()
            resumed = Trainer(options, run_dir=run_dir, log_every_n_steps=FIT_LOG,
                              datasets=fit_datasets(), verbose=False)
            resumed.resume(os.path.join(run_dir, "checkpoints", f"step_{RESUME_AT}"))
            _, counts = counted(lambda: resumed.fit(max_steps=RESUME_FIT,
                                                    eval_interval=RESUME_AT))
            launches += counts[0]
            assert_state_equal(to_host(resumed.state.state_dict()), want)
            slots = sum(len(v) for v in want["optimizer"]["state"].values())
            log(f"[optimizers] {name}: Trainer fit {RESUME_FIT} steps, a fresh Trainer "
                f"resumed at step {RESUME_AT} and fit to {RESUME_FIT}: {len(want['model'])} "
                f"model and {slots} optimizer tensors, the count, norm and generator equal "
                f"bit for bit")
            del resumed, want
            free_memory()
        finally:
            shutil.rmtree(run_dir, ignore_errors=True)
    return launches


def event_sites(seed):
    """The occupied sites ``[M, 3]`` (image, x, y) of one b16 batch's event
    bank and their summed raw values ``[M, 3]`` float32 (duplicates added)."""
    batch = Batcher(InMemoryEvents(TRAIN_BATCH, seed), batch_size=TRAIN_BATCH).build_batch(
        np.arange(TRAIN_BATCH))
    t = to_device(batch, "cpu")
    grid = densify_images_plain(t["event_xy"], t["event_vals"] / 255.0, t["event_owner"],
                                TRAIN_BATCH, H, W)
    occupied = grid.abs().sum(-1) > 0
    return occupied.nonzero().numpy(), grid[occupied].numpy()


def check_coo_conv(smi):
    """The general COO convolution: native maps equal to numpy's, host ms of
    each, and ``coo_conv_apply`` on the card against ``sparse_conv``."""
    coords, features = event_sites(SEED + 21)
    rng = np.random.default_rng(SEED + 22)
    features = torch.from_numpy(features).cuda()
    height, width = H, W
    for label, k, stride, c_out in COO_LAYERS:
        c_in = features.shape[1]
        maps = build_conv_maps(coords, k, stride, height, width)
        plain = build_conv_maps_numpy(coords, k, stride, height, width)
        assert maps.num_out == plain.num_out
        for a, b in zip(maps[:1] + maps[2:], plain[:1] + plain[2:]):
            assert a.dtype == b.dtype and np.array_equal(a, b), label
        native_ms = median_ms(lambda: build_conv_maps(coords, k, stride, height, width))
        numpy_ms = median_ms(lambda: build_conv_maps_numpy(coords, k, stride, height, width))
        weights = torch.from_numpy((rng.normal(size=(k, k, c_in, c_out))
                                    / math.sqrt(k * k * c_in)).astype(np.float32)).cuda()
        in_maps = torch.from_numpy(maps.in_maps).cuda()
        out_maps = torch.from_numpy(maps.out_maps).cuda()
        got = coo_conv_apply(features, weights, in_maps, out_maps, maps.num_out)
        sites = torch.from_numpy(coords).cuda()
        dense = features.new_zeros((TRAIN_BATCH, height, width, c_in))
        dense[sites[:, 0], sites[:, 1], sites[:, 2]] = features
        occupancy = torch.zeros((TRAIN_BATCH, height, width), dtype=torch.bool, device="cuda")
        occupancy[sites[:, 0], sites[:, 1], sites[:, 2]] = True
        grid = SparseGrid(dense, occupancy)
        torch_weight = weights.permute(3, 2, 0, 1).contiguous()
        want = sparse_conv(grid, torch_weight, stride)
        out_sites = torch.from_numpy(maps.out_coords).cuda()
        expected = want.features[out_sites[:, 0], out_sites[:, 1], out_sites[:, 2]]
        torch.testing.assert_close(got, expected, **COO_CONV_TOL)
        assert int(want.occupancy.sum()) == maps.num_out
        assert bool(want.occupancy[out_sites[:, 0], out_sites[:, 1], out_sites[:, 2]].all())
        err = (got - expected).abs().max().item()
        apply_ms = cuda_time_ms(
            lambda: coo_conv_apply(features, weights, in_maps, out_maps, maps.num_out))
        dense_ms = cuda_time_ms(lambda: sparse_conv(grid, torch_weight, stride))
        pairs = int((maps.in_maps < len(coords)).sum())
        log(f"[coo_conv] {label} ({c_in} -> {c_out}) on the b{TRAIN_BATCH} event bank: "
            f"{len(coords)} sites -> {maps.num_out}, {pairs} pairs (maps [{k * k}, "
            f"{maps.in_maps.shape[1]}]); maps native = numpy, host {native_ms:.3f} / "
            f"{numpy_ms:.3f} ms; coo_conv_apply on the card {apply_ms:.4f} ms against "
            f"sparse_conv {dense_ms:.4f} ms, max diff {err:.3g} (float32, bound "
            f"{COO_CONV_TOL}) ({smi})")
        coords, features = maps.out_coords, got.detach()
        height, width = ((height - 1) // stride + 1, (width - 1) // stride + 1)
        del grid, dense, want, expected
    free_memory()


def check_gather(smi):
    """The CSR gather of RAM-held banks: native against numpy, host ms."""
    ds = InMemoryEvents(GATHER_EVENTS, SEED + 23)
    rng = np.random.default_rng(SEED + 24)
    readings = []
    for size in GATHER_BATCHES:
        idx = rng.choice(GATHER_EVENTS, size, replace=False)
        got, want = ds.gather_events(idx), ds.gather_events(idx, native=False)
        assert sorted(got) == sorted(want)
        for key in want:
            assert got[key].dtype == want[key].dtype and np.array_equal(got[key], want[key]), key
        native_ms = median_ms(lambda: ds.gather_events(idx))
        numpy_ms = median_ms(lambda: ds.gather_events(idx, native=False))
        readings.append(f"b{size} ({len(got['event_coords'])} + {len(got['prong_coords'])} "
                        f"hits) native {native_ms:.4f} ms, numpy {numpy_ms:.4f} ms")
    log("[gather] gather_events of InMemoryEvents, native = numpy array for array: "
        + "; ".join(readings) + f" (host, median of {HOST_REPEATS}; {smi})")


def check_decoder(smi):
    """DecoderLayer and ISAB on the card against the CPU in float32:
    forward, the inputs' and every parameter's gradient."""
    batch, tokens, hidden, heads, indices = DECODER_SHAPE
    rng = np.random.default_rng(SEED + 25)
    x = torch.from_numpy(rng.normal(size=(batch, tokens, hidden)).astype(np.float32))
    memory = torch.from_numpy(rng.normal(size=(batch, tokens, hidden)).astype(np.float32))
    counts = torch.from_numpy(rng.integers(2, tokens + 1, batch))
    mask = torch.arange(tokens)[None, :] < counts[:, None]
    key_mask = mask[:, None, None, :]
    cotangent = torch.from_numpy(rng.normal(size=(batch, tokens, hidden)).astype(np.float32))
    generator = torch.Generator().manual_seed(SEED)
    cases = (
        ("DecoderLayer", DecoderLayer(hidden, heads, generator=generator),
         lambda m, t, mem, k: m(t, mem, memory_mask=k, self_mask=k)),
        (f"ISAB m={indices}", InducedSetAttentionBlock(hidden, hidden, heads, indices,
                                                       generator=generator),
         lambda m, t, mem, k: m(t, k[:, 0, 0])))
    for name, module, call in cases:
        results = []
        for device in ("cpu", "cuda"):
            m = copy.deepcopy(module).to(device)
            t = x.detach().clone().to(device).requires_grad_()
            out = call(m, t, memory.to(device), key_mask.to(device))
            (out * cotangent.to(device)).sum().backward()
            results.append((out.detach().cpu(), t.grad.cpu(),
                            {n: p.grad.cpu() for n, p in m.named_parameters()}))
        (want, want_x, want_p), (got, got_x, got_p) = results
        torch.testing.assert_close(got, want, **DECODER_TOL)
        worst = 0.0
        for label, g, w in [("input", got_x, want_x)] + [(n, got_p[n], want_p[n])
                                                          for n in want_p]:
            diff = (g - w).abs().max().item()
            bound = DECODER_GRAD_SHARE * w.abs().max().item() + 1e-7
            assert diff <= bound, (name, label, diff, bound)
            worst = max(worst, diff / bound)
        log(f"[decoder] {name}, hidden {hidden}, {heads} heads, {tokens} tokens, b{batch}, "
            f"float32: the card against the CPU, output max diff "
            f"{(got - want).abs().max().item():.3g} (bound {DECODER_TOL}); {len(want_p) + 1} "
            f"gradients within {DECODER_GRAD_SHARE} of their largest, the worst at "
            f"{worst:.1%} of its bound ({smi})")


def check_one_hot(smi):
    """The option file's dense network with one-hot pixels (768 channels):
    K1 at C = 768 against its plain version, b16 serving and the train step
    (or the largest batch that fits).  Returns K1's launches."""
    cfg = dataclasses.replace(production_config("bfloat16"), one_hot_pixels=True)
    assert cfg.pixel_channels * 256 == 768
    model = TransformerCVN(cfg, generator=torch.Generator().manual_seed(SEED)).cuda().eval()
    ds = InMemoryEvents(ONE_HOT_EVENTS, SEED + 26)
    batch = to_device(Batcher(ds, batch_size=TRAIN_BATCH).build_batch(
        np.arange(TRAIN_BATCH)), "cuda")
    readings, launches = [], 0
    with torch.no_grad():
        for key, n in (("small", ONE_HOT_SMALL), ("event", TRAIN_BATCH),
                       ("prong", batch["slot_batch"].shape[0])):
            bank = "event" if key == "small" else key
            starts = batch[f"{bank}_starts"][:n + 1].contiguous()
            rows = int(starts[-1]) if key == "small" else batch[f"{bank}_xy"].shape[0]
            xy, owner = batch[f"{bank}_xy"][:rows], batch[f"{bank}_owner"][:rows]
            vals = model.preprocess_values(batch[f"{bank}_vals"][:rows])
            assert vals.shape[1] == 768 and vals.dtype == torch.bfloat16
            reset_counts()
            out = densify_images_cuda(xy, vals, starts, n, H, W, False)
            torch.cuda.synchronize()
            assert read_counts() == (1, 0) and out.shape == (n, H, W, 768)
            err = 0.0
            for i0 in range(0, n, ONE_HOT_CHUNK):
                i1 = min(n, i0 + ONE_HOT_CHUNK)
                sel = (owner >= i0) & (owner < i1)
                ref = densify_images_plain(xy[sel], vals[sel], owner[sel] - i0, i1 - i0, H, W)
                torch.testing.assert_close(out[i0:i1].float(), ref.float(),
                                           **K1_TOL[torch.bfloat16])
                err = max(err, (out[i0:i1].float() - ref.float()).abs().max().item())
                del ref
            used = int(starts[-1])
            nbytes = out.numel() * out.element_size() + used * (8 + 768 * 2) + (n + 1) * 4
            del out
            free_memory()
            bound = 1e3 * nbytes / HBM_BYTES_PER_S
            k_ms = cuda_time_ms(lambda: densify_images_cuda(xy, vals, starts, n, H, W, False))
            d_ms = cuda_time_ms(lambda: densify_images_cuda(xy, vals, starts, n, H, W, False),
                                queued=True)
            p_ms = cuda_time_ms(lambda: densify_images_plain(xy, vals, owner, n, H, W))
            readings.append(f"{key} bank [{n}, {H}, {W}, 768] ({used} hits): max diff "
                            f"{err:.3g}, kernel {k_ms:.4f} ms (device {d_ms:.4f}), plain "
                            f"{p_ms:.4f} ms, bound {bound:.4f} ms ({nbytes / 1e9:.2f} GB), "
                            f"{bound / k_ms:.1%} of it")
            free_memory()
    log("[one-hot] K1 at C = 768, bfloat16, against the plain version: "
        + "; ".join(readings) + f" ({smi})")
    del batch
    free_memory()

    _, counts = serve(model, ds, TRAIN_BATCH)                  # warm-up
    launches += counts[0]
    torch.cuda.reset_peak_memory_stats()
    rates = []
    for _ in range(ONE_HOT_PASSES):
        seconds, counts = serve(model, ds, TRAIN_BATCH)
        launches += counts[0]
        rates.append(ONE_HOT_EVENTS / seconds)
    log(f"[one-hot] predict_split b{TRAIN_BATCH}: {ONE_HOT_EVENTS} events x {ONE_HOT_PASSES} "
        f"passes, median {statistics.median(rates):.2f} events/s, min {min(rates):.2f}, max "
        f"{max(rates):.2f}; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
        f"({smi})")
    del model
    free_memory()

    failed = []
    for size in ONE_HOT_TRAIN_BATCHES:
        reading = None
        try:
            reading = train_reading(cfg, size, ONE_HOT_WARMUP, ONE_HOT_STEPS, SEED + 27)
        except torch.cuda.OutOfMemoryError as e:      # the reading, not a failure
            failed.append(f"b{size}: out of memory ({str(e).splitlines()[0][:160]})")
        if reading is None:
            free_memory()                             # the failed step's frames are gone
            continue
        ms, peak, k1 = reading
        launches += k1
        log("[one-hot] train step " + "".join(f"{f}; " for f in failed)
            + f"b{size}: {ms:.2f} ms/step, {1e3 * size / ms:.2f} events/s, peak memory "
            f"{peak:.2f} GiB ({ONE_HOT_STEPS} steps after {ONE_HOT_WARMUP}; {smi})")
        break
    else:
        raise AssertionError(f"no one-hot train step fits: {failed}")
    return launches


def check_remaining_modules(smi):
    """Phase 12; returns K1's launches."""
    launches = check_optimizers(smi)
    check_coo_conv(smi)
    check_gather(smi)
    check_decoder(smi)
    launches += check_one_hot(smi)
    log(f"[phase 12] K1 {launches}")
    return launches

# ---------------------------------------------------------------------------
# phase 13
# ---------------------------------------------------------------------------

def read_loader_outputs(path):
    """The C++ loader's out.bin: u32 count, then per output u32 rank, i64
    dims, u32 PJRT dtype code (11: float32) and the raw bytes."""
    outs = []
    with open(path, "rb") as f:
        (n,) = struct.unpack("<I", f.read(4))
        for _ in range(n):
            (rank,) = struct.unpack("<I", f.read(4))
            dims = struct.unpack(f"<{rank}q", f.read(8 * rank))
            (dtype,) = struct.unpack("<I", f.read(4))
            assert dtype == 11, dtype
            outs.append(np.frombuffer(f.read(4 * int(np.prod(dims))), "<f4").reshape(dims))
    return outs


def loader_reading(stderr, prefix):
    """The loader's stderr line starting with ``prefix``."""
    return next(line for line in stderr.splitlines() if line.startswith(prefix))


def check_aoti_serving(smi, served, export_dir, card_free=None):
    """Phase 13: phase 11's ``pid`` programs (the option file's network at
    ``CUT_DEPTH``) at P = 4 and 20 packaged with AOTInductor for the card
    (``package_run_dir`` with its bench), then the C++ loader built and run
    as a subprocess on one real event, each output held to the eager graph
    of the rung it chose.  ``card_free``: called before the first package
    is timed (``timing_after``), to wait for other work on the card."""
    model, norm, ds = served
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool, (
            timing_after(card_free) if card_free else contextlib.nullcontext()):
        # g++ builds the loader on a spare core while Inductor compiles
        loader_build = pool.submit(lambda: (build_loader(), time.perf_counter() - t0))
        paths = package_run_dir(None, export_dir, variants=("pid",), prong_buckets=AOTI_RUNGS,
                                device="cuda", bench=True)
        package_s = time.perf_counter() - t0
        loader, build_s = loader_build.result()
    meta_path = os.path.join(export_dir, "transformercvn_export_meta.json")
    with open(meta_path) as f:
        meta = json.load(f)
    assert meta["aoti_platform"] == "cuda" and meta["aoti_prong_buckets"] == list(AOTI_RUNGS)
    compile_s, aoti_ms, eager_ms = meta["aoti_compile_s"], meta["aoti_bucket_ms"], meta["bucket_ms"]
    log(f"[aoti] pid at depth {CUT_DEPTH} packaged for cuda at P = {AOTI_RUNGS} in "
        f"{package_s:.2f} s, timing included: compile "
        + ", ".join(f"{k} {v:.2f} s" for k, v in compile_s.items()) + f" ({smi})")
    for p in AOTI_RUNGS:
        log(f"[aoti] P={p}: package {aoti_ms[str(p)]:.4f} ms an event against the eager "
            f"program's bucket_ms {eager_ms[str(p)]:.4f} ms "
            f"({eager_ms[str(p)] / aoti_ms[str(p)]:.1f}x; export._time_bucket_ms, {smi})")
    log(f"[aoti] C++ loader {os.path.basename(loader)} built in {build_s:.2f} s, beside "
        f"the packages' compile")

    graph_ms = meta["aoti_graph_bucket_ms"]
    for p in AOTI_RUNGS:
        key = "pid" if p == model.cfg.max_prongs else f"pid_p{p}"
        captured_equals(load_package(paths[key], graph=True), load_package(paths[key]),
                        serving_rows(ds, model.cfg.max_prongs, p, 3), f"package {key}")
    log("[aoti] packages captured as one CUDA graph each (load_package graph=True), "
        "bit-equal to the package run uncaptured on 3 events; per event: "
        + ", ".join(f"P={p}: package {aoti_ms[str(p)]:.4f} ms, graph "
                    f"{graph_ms[str(p)]:.4f} ms ({aoti_ms[str(p)] / graph_ms[str(p)]:.2f}x)"
                    for p in AOTI_RUNGS) + f" ({smi})")

    index = next(i for i in range(len(ds)) if int((ds.prong_targets[i] >= 0).sum()) <= 3)
    full, real = event_pixel_maps(ds, index, model.cfg.max_prongs)
    pixels_bin = os.path.join(export_dir, "event.bin")
    full.cpu().numpy().tofile(pixels_bin)
    for (n, graph), costs in ((case, {int(k): v for k, v in
                                      (graph_ms if case[1] else aoti_ms).items()})
                              for case in itertools.product(AOTI_PRONGS, (False, True))):
        out_bin = os.path.join(export_dir, f"out_{n}.bin")
        proc = subprocess.run(
            [str(loader), os.path.join(export_dir, "transformercvn_pid"), meta_path, pixels_bin,
             str(n), out_bin, "--device", "cuda", "--repeat", str(AOTI_REPEAT),
             *(["--graph"] if graph else [])],
            capture_output=True, text=True, timeout=AOTI_TIMEOUT_S)
        if proc.returncode != 0:
            raise RuntimeError(f"the loader exited {proc.returncode}:\n{proc.stderr[-4000:]}")
        chosen = int(loader_reading(proc.stderr, "num_prongs").split("bucket ")[1].split()[0])
        assert chosen == select_bucket(AOTI_RUNGS, n, costs) and chosen >= n, (n, chosen, costs)
        assert ("[graph cost-aware" in proc.stderr) == graph, proc.stderr
        got = read_loader_outputs(out_bin)
        count = torch.tensor(n, dtype=torch.int32, device="cuda")
        with torch.inference_mode():
            want = [w.float().cpu().numpy() for w in build_inference_fn(
                with_max_prongs(model, chosen), "pid", norm)(full[:1 + chosen], count)]
        assert [g.shape for g in got] == [w.shape for w in want], ([g.shape for g in got],)
        event_diff = float(np.abs(got[0] - want[0]).max())
        prong_diff = float(np.abs(got[1][:n] - want[1][:n]).max())
        assert np.isfinite(got[0]).all() and np.isfinite(got[1]).all()
        assert got[0].argmax() == want[0].argmax(), (got[0], want[0])
        assert (got[1][:n].argmax(-1) == want[1][:n].argmax(-1)).all(), n
        assert max(event_diff, prong_diff) <= FOLD_SHARE, (event_diff, prong_diff)
        log(f"[aoti] loader{' --graph' if graph else ''}, num_prongs {n} (the event has "
            f"{real}): {loader_reading(proc.stderr, 'num_prongs')}; "
            f"{loader_reading(proc.stderr, 'loaded')}; "
            + (f"{loader_reading(proc.stderr, 'captured')}; " if graph else "")
            + f"{loader_reading(proc.stderr, 'first run')}; "
            f"{loader_reading(proc.stderr, 'run:')}; against the eager graph: argmax equal, "
            f"max prob diff event {event_diff:.3g}, prongs {prong_diff:.3g} (bound "
            f"{FOLD_SHARE}; {smi})")
    return paths


# ---------------------------------------------------------------------------
# phase 14
# ---------------------------------------------------------------------------

def tp_options(data_shards, mp=TP_MP):
    """The option file's network at ``DP_BATCH`` a data shard over
    ``data_shards * mp`` ranks.  With one data shard the options' dropout and
    pixel noise stay (a world of one draws the same); with more each shard
    draws its own, so they are off for the comparison."""
    options = fit_options()
    options.batch_size = DP_BATCH
    options.num_gpu = data_shards * mp
    options.model_parallel = mp
    if data_shards > 1:
        options.dropout, options.pixel_noise_std = 0.0, 0.0
    return options


def tp_datasets():
    return (InMemoryEvents(DP_EVENTS, SEED + 30), InMemoryEvents(DP_VAL_EVENTS, SEED + 31),
            None)


def tp_full_options(ranks, mp=TP_MP):
    """The option file's whole network, bfloat16, ``TP_FULL_BATCH`` a data
    shard over ``ranks`` ranks of ``mp`` a row."""
    options = Options.load(OPTION_FILE)
    options.compute_dtype = "bfloat16"
    options.batch_size = TP_FULL_BATCH
    options.num_gpu, options.model_parallel = ranks, mp
    return options


def full_depth_step(options, device):
    """``options``' Trainer at full depth: (ms/step of its bare step, peak
    GiB from its build through its steps, K1 launches)."""
    free_memory()
    torch.cuda.reset_peak_memory_stats(device)
    events = options.batch_size * options.num_gpu * (TP_FULL_WARMUP + TP_FULL_STEPS)
    trainer = Trainer(options, debug=True, device=device, verbose=False,
                      datasets=(InMemoryEvents(events, SEED + 32),
                                InMemoryEvents(DP_VAL_EVENTS, SEED + 33), None))
    ms, counts = counted(lambda: bare_step_ms(trainer, TP_FULL_WARMUP, TP_FULL_STEPS))
    peak = torch.cuda.max_memory_allocated(device) / 2**30
    assert counts == (2 * (TP_FULL_WARMUP + TP_FULL_STEPS), 0), counts
    del trainer
    free_memory()
    return ms, peak, counts[0]


def float32_first_loss(options, device):
    """The first train step's loss of ``options``' Trainer in float32 on
    the first global batch of ``tp_datasets()``: the same function of the
    same weights and events on any layout."""
    options.compute_dtype = "float32"
    trainer = Trainer(options, debug=True, device=device, verbose=False,
                      datasets=tp_datasets())
    batch = to_device(trainer.train_batcher.build_batch(np.arange(trainer.global_batch)),
                      device)
    loss = float(trainer.train_step(trainer.state, batch)["train_loss"])
    del trainer
    free_memory()
    return loss


def compiled_tp_step(data_shards, device, go_path):
    """The compiled TP step at ``CUT_DEPTH`` beside the eager one, static
    shapes, dropout and noise 0: both first losses on the same batch and
    weights, the compiled first call's seconds (the compile), and, once
    ``go_path`` exists, the compiled step's ms/step and K1 launches over
    its warm-up and timed steps."""
    options = tp_options(data_shards)
    options.static_batch_shapes = True
    options.dropout, options.pixel_noise_std = 0.0, 0.0
    losses, seconds = [], 0.0
    for compile in (False, True):
        trainer = Trainer(options, debug=True, device=device, verbose=False,
                          datasets=tp_datasets(), compile=compile)
        batch = to_device(next(trainer.train_batcher.epoch(1)), device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(trainer.train_step(trainer.state, batch)["train_loss"]))
        seconds = time.perf_counter() - t0
    while not os.path.exists(go_path):
        time.sleep(0.5)
    ms, counts = counted(lambda: bare_step_ms(trainer, TP_COMPILED_WARMUP, TP_COMPILED_STEPS))
    del trainer
    free_memory()
    return dict(eager_loss=losses[0], loss=losses[1], compile_s=seconds, ms_per_step=ms,
                counts=counts)


def host_digest(state):
    """sha256 of the tensors of a host state (``to_host`` of a state dict),
    in order."""
    digest = hashlib.sha256()
    stack = [state]
    while stack:
        node = stack.pop(0)
        if isinstance(node, dict):
            stack = [node[k] for k in node] + stack
        elif isinstance(node, (list, tuple)):
            stack = list(node) + stack
        elif torch.is_tensor(node):
            digest.update(node.reshape(-1).contiguous().view(torch.uint8).numpy().tobytes())
    return digest.hexdigest()


def join_tp_group(rank, ranks, backend, rendezvous):
    """This process as rank ``rank`` of a TP group: its card, TF32 off, the
    group joined; returns the device."""
    import faulthandler

    import torch.distributed as dist

    faulthandler.enable()       # a crash in a collective prints its Python stack
    device = torch.device("cuda", rank if backend == "nccl" else 0)
    torch.cuda.set_device(device)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group(backend, init_method=f"file://{rendezvous}",
                            world_size=ranks, rank=rank,
                            timeout=datetime.timedelta(seconds=TP_TIMEOUT_S))
    dist.all_reduce(torch.zeros(1, device=device))   # the ranks meet once, in step
    return device


def start_tp_ranks(target, ranks, backend, work, *args, env=None):
    """``ranks`` processes, each running ``chip_smoke.<target>(rank, ranks,
    backend, rendezvous, *args, out_path)``, their output to a log file
    each; returns them and their output paths."""
    here = os.path.dirname(os.path.abspath(__file__))
    outs = [os.path.join(work, f"{target}_{r}.json") for r in range(ranks)]
    procs = []
    for r in range(ranks):
        with open(f"{outs[r]}.log", "w") as out:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", f"import sys, chip_smoke; chip_smoke.{target}("
                 "*map(int, sys.argv[1:3]), *sys.argv[3:])",
                 str(r), str(ranks), backend, os.path.join(work, f"{target}_rendezvous"),
                 *map(str, args), outs[r]],
                cwd=here, stdout=out, stderr=subprocess.STDOUT,
                env={**os.environ, **(env or {}), "LOCAL_RANK": str(r),
                     "LOCAL_WORLD_SIZE": str(ranks)}))
    return procs, outs


def stop(procs):
    for p in procs:
        p.kill()
        p.wait()


def finish_tp_ranks(procs, outs, timeout):
    """Wait for the ranks (killing them at ``timeout``); any rank's failure
    raises with its output; returns their results."""
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        stop(procs)
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            with open(f"{out}.log") as f:
                raise RuntimeError(f"tensor-parallel rank {r} exited {p.returncode}:\n"
                                   + f.read()[-6000:])
    results = []
    for path in outs:
        with open(path) as f:
            results.append(json.load(f))
    return results


def tp_layout(ranks):
    """``(ranks, backend, dp)`` of the TP phase on this host's cards."""
    cards = torch.cuda.device_count()
    ranks = ranks or (2 * TP_MP if cards >= 2 * TP_MP else TP_MP)
    return ranks, "nccl" if cards >= ranks else "gloo", ranks // TP_MP


def compiled_tp_rank(rank, ranks, backend, rendezvous, go_path, out_path):
    """One rank of the compiled TP step (a process of its own, at a low
    priority, so that it compiles beside phases 13 and 10 without taking
    their timings' cores): compiles, then waits for ``go_path`` before it
    is timed."""
    import torch.distributed as dist

    os.nice(10)
    device = join_tp_group(rank, ranks, backend, rendezvous)
    try:
        out = compiled_tp_step(ranks // TP_MP, device, go_path)
    finally:
        dist.destroy_process_group()
    with open(out_path, "w") as f:
        json.dump(out, f)


def start_compiled_tp(work):
    """The compiled TP step's ranks, started (they compile at once, with
    ``WARM_THREADS`` compile workers each, and wait for
    ``finish_compiled_tp`` before they are timed)."""
    ranks, backend, _ = tp_layout(None)
    go_path = os.path.join(work, "compiled_tp_go")
    return go_path, start_tp_ranks(
        "compiled_tp_rank", ranks, backend, work, go_path,
        env={"TORCHINDUCTOR_COMPILE_THREADS": str(WARM_THREADS)})


def finish_compiled_tp(started, smi):
    """Let the compiled TP ranks time their steps, check them against their
    eager first step and K1's count; returns K1's launches."""
    go_path, (procs, outs) = started
    open(go_path, "w").close()
    results = finish_tp_ranks(procs, outs, TP_TIMEOUT_S)
    steps = TP_COMPILED_WARMUP + TP_COMPILED_STEPS
    for rank, c in enumerate(results):
        log(f"[tp] rank {rank} compiled (CUT_DEPTH, static shapes, dropout 0): first call "
            f"{c['compile_s']:.1f} s (the compile, beside phase 13), then "
            f"{c['ms_per_step']:.2f} ms/step ({TP_COMPILED_STEPS} steps after "
            f"{TP_COMPILED_WARMUP}); first loss {c['loss']:.5f} against eager TP's "
            f"{c['eager_loss']:.5f}; K1 {c['counts'][0]} from inside the graph ({smi})")
    for c in results:
        assert c["counts"] == [2 * steps, 0], c["counts"]
        assert math.isfinite(c["loss"]) and math.isfinite(c["ms_per_step"]), c
        np.testing.assert_allclose(c["loss"], c["eager_loss"], **TP_LOSS_TOL)
    return sum(c["counts"][0] for c in results)


def tensor_parallel_rank(rank, ranks, backend, rendezvous, work, out_path):
    """One rank of phase 14 (a process of its own): fits with tensor
    parallelism, checkpoints, resumes in a fresh Trainer, times its step,
    then a float32 step and the full-depth step, and writes what the parent
    checks to ``out_path``."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    device = join_tp_group(rank, ranks, backend, rendezvous)
    seconds, t0 = {}, time.perf_counter()
    try:
        options = tp_options(ranks // TP_MP)
        run_dir = os.path.join(work, "run")
        trainer = Trainer(options, run_dir=run_dir, log_every_n_steps=1, device=device,
                          verbose=False, datasets=tp_datasets())
        assert trainer.mesh.mp == TP_MP and trainer.num_shards == ranks // TP_MP
        model = trainer.state.model
        pieces = {name: [t.to_local().numel(), t.numel()]
                  for name, t in (*model.named_parameters(), *model.named_buffers())
                  if isinstance(t, DTensor)}
        torch.cuda.reset_peak_memory_stats(device)
        result, fit_counts = counted(lambda: trainer.fit(max_steps=TP_STEPS,
                                                         eval_interval=TP_STEPS))
        peak = torch.cuda.max_memory_allocated(device) / 2**30
        digest = host_digest(to_host(trainer.state.state_dict()))
        losses = ([v for _, v in read_history(run_dir)["train_loss"]] if rank == 0 else [])
        resumed = Trainer(options, debug=True, device=device, verbose=False,
                          datasets=tp_datasets())
        resumed.resume(os.path.join(run_dir, "checkpoints", f"step_{TP_STEPS}"))
        resumed_digest = host_digest(to_host(resumed.state.state_dict()))
        del resumed
        bare_ms = bare_step_ms(trainer, TP_BARE_WARMUP, TP_BARE_STEPS)
        out = dict(rank=rank, device=str(device), mesh=[trainer.mesh.dp, trainer.mesh.mp,
                                                       trainer.mesh.data_index],
                   pieces=pieces, fit_counts=fit_counts, peak_gib=peak, state=digest,
                   resumed=resumed_digest, losses=losses, val_loss=result["val_loss"],
                   val_auc=result["val_epoch_AUC"], ms_per_step=bare_ms,
                   global_batch=trainer.global_batch, seconds=seconds)
        del trainer, model
        free_memory()
        seconds["fit, resume, bare steps"] = time.perf_counter() - t0
        out["float32_loss"] = float32_first_loss(tp_options(ranks // TP_MP), device)
        seconds["float32 step"] = time.perf_counter() - t0 - sum(seconds.values())
        out["full"] = dict(zip(("ms_per_step", "peak_gib", "k1"),
                               full_depth_step(tp_full_options(ranks), device)))
        seconds["full depth"] = time.perf_counter() - t0 - sum(seconds.values())
    finally:
        dist.destroy_process_group()
    with open(out_path, "w") as f:
        json.dump(out, f)


def check_tensor_parallel(smi, ranks=None):
    """Phase 14: dp x mp ranks of a tensor-parallel Trainer (dp1 x mp2 on
    one card, over gloo with CUDA tensors; over nccl, one card a rank, where
    there are enough; dp2 x mp2 on 4 cards), then a world-of-one Trainer on
    the same global batches; returns K1's launches over the ranks."""
    ranks, backend, dp = tp_layout(ranks)
    cards = torch.cuda.device_count()
    where = (f"nccl, one card each ({cards} cards)" if backend == "nccl"
             else "gloo with CUDA tensors, every rank on the one card")
    log(f"[tp] dp{dp} x mp{TP_MP}: {ranks} ranks over {where}")
    work = tempfile.mkdtemp(prefix="chip_smoke_tp_")
    try:
        t0 = time.perf_counter()
        results = finish_tp_ranks(*start_tp_ranks("tensor_parallel_rank", ranks, backend,
                                                  work, work), TP_TIMEOUT_S)
        seconds = time.perf_counter() - t0
        val_batches = math.ceil(DP_VAL_EVENTS / (dp * DP_BATCH))
        losses = results[0]["losses"]

        # a world of one on the same global batches, seed and weights
        run_dir = os.path.join(work, "one")
        options = tp_options(dp)
        options.batch_size = results[0]["global_batch"]
        options.num_gpu, options.model_parallel = 1, 1
        one = Trainer(options, run_dir=run_dir, log_every_n_steps=1, verbose=False,
                      datasets=tp_datasets())
        one.fit(max_steps=TP_STEPS, eval_interval=TP_STEPS)
        single = [v for _, v in read_history(run_dir)["train_loss"]]
        del one
        free_memory()
        single_fp32 = float32_first_loss(options, torch.device("cuda", 0))
        # the full-depth b16 step of a world of one, beside each TP rank's
        options = tp_full_options(1, 1)
        options.batch_size = TP_FULL_BATCH * dp
        one_ms, one_peak, one_k1 = full_depth_step(options, torch.device("cuda", 0))

        sharded = len(results[0]["pieces"])
        whole = sum(w for _, w in results[0]["pieces"].values())
        log(f"[tp] dp{dp} x mp{TP_MP} ({backend}): fit {TP_STEPS} steps + 1 validation of "
            f"{val_batches} batches and a checkpoint, a fresh Trainer resumed from it, a "
            f"float32 step and a full-depth step, in {seconds:.1f} s of the "
            f"processes' life; {sharded} tensors sharded over \"model\" ({whole} "
            f"elements, 1/{TP_MP} a rank); train_loss {[round(v, 5) for v in losses]} "
            f"against a world of one's {[round(v, 5) for v in single]}; float32 first loss "
            f"{results[0]['float32_loss']:.6f} against {single_fp32:.6f}; K1 per rank "
            f"{results[0]['fit_counts'][0]}, K2 0")
        for r in results:
            f = r["full"]
            log(f"[tp] rank {r['rank']} on {r['device']}: {r['ms_per_step']:.2f} ms/step "
                f"({TP_BARE_STEPS} steps bare after {TP_BARE_WARMUP}), "
                f"{r['global_batch'] / r['ms_per_step'] * 1e3:.2f} events/s over the ranks; "
                f"peak memory {r['peak_gib']:.2f} GiB; seconds "
                f"{ {k: round(v, 1) for k, v in r['seconds'].items()} } ({smi})")
            log(f"[tp] full depth, b{TP_FULL_BATCH} a data shard: rank {r['rank']} "
                f"{f['ms_per_step']:.2f} ms/step, peak {f['peak_gib']:.2f} GiB; world of "
                f"one at b{TP_FULL_BATCH * dp}: {one_ms:.2f} ms/step, peak {one_peak:.2f} GiB "
                f"({TP_FULL_STEPS} steps bare after {TP_FULL_WARMUP}; {smi})")

        for r in results:
            assert r["mesh"] == [dp, TP_MP, r["rank"] // TP_MP], r["mesh"]
            assert r["fit_counts"] == [2 * (TP_STEPS + val_batches), 0], r["fit_counts"]
            assert r["pieces"] and all(local * TP_MP == whole
                                       for local, whole in r["pieces"].values()), r["pieces"]
            assert r["resumed"] == r["state"], "the resumed state differs"
            assert math.isfinite(r["val_loss"]) and math.isfinite(r["val_auc"]), r
            assert r["full"]["peak_gib"] < one_peak, (r["full"]["peak_gib"], one_peak)
        assert len({r["state"] for r in results}) == 1, "the ranks' whole states differ"
        assert len(losses) == TP_STEPS and all(math.isfinite(v) for v in losses), losses
        np.testing.assert_allclose(results[0]["float32_loss"], single_fp32, **PATH_TOL)
        np.testing.assert_allclose(losses, single, **TP_LOSS_TOL)
        return sum(r["fit_counts"][0] + r["full"]["k1"] for r in results) + one_k1
    finally:
        shutil.rmtree(work, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 15
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def bench_precision():
    """torch's default float32 matmul setting, as the bench runs.  Inductor's
    FX-graph cache keys on ``torch.backends.cuda.matmul.fp32_precision``,
    which phase 1's TF32 switch turns from "none" to "ieee" (the same
    arithmetic: matmul TF32 is off by default), so the bf16 graphs compiled
    here meet the bench's cache entries only under the bench's setting."""
    matmul = torch.backends.cuda.matmul
    saved = matmul.fp32_precision
    matmul.fp32_precision = "none"
    try:
        yield
    finally:
        matmul.fp32_precision = saved


def cache_counts():
    """Inductor's FX-graph cache hits and misses in this process so far."""
    stats = torch._dynamo.utils.counters["inductor"]
    return stats["fxgraph_cache_hit"], stats["fxgraph_cache_miss"]


def cache_reading(before):
    hits, misses = (now - then for now, then in zip(cache_counts(), before))
    return f"FX-graph cache {hits} hit(s), {misses} miss(es)"


def serving_model(embedder="dense"):
    cfg = dataclasses.replace(cut_config("bfloat16"), embedder=embedder)
    return TransformerCVN(cfg, generator=torch.Generator().manual_seed(SEED)).cuda()


def serving_events(batch_size):
    """The bench's serving events at ``batch_size``."""
    return InMemoryEvents(bench.SERVE_EVENTS[batch_size], bench.SEED + 1)


def bf16_train_setup(**flags):
    """The bench's b16 train row: the option file at ``CUT_DEPTH`` in bf16
    (``flags``: model config fields, e.g. a memory recipe), its batch, a
    fresh model and train state."""
    options = fit_options()
    ds = InMemoryEvents(TRAIN_BATCH, bench.SEED + 2)
    batch = to_device(Batcher(ds, batch_size=TRAIN_BATCH).build_batch(
        np.arange(TRAIN_BATCH)), "cuda")
    model = TransformerCVN(dataclasses.replace(cut_config("bfloat16"), **flags),
                           generator=torch.Generator().manual_seed(SEED)).cuda()
    state = create_train_state(model, options, ds.norm(), 100, seed=SEED)
    return options, model, state, batch


def eval_batches():
    """The bench's b16 serving events as validation batches, static shapes."""
    val = serving_events(TRAIN_BATCH)
    return val, [to_device(b, "cuda") for b in Batcher(
        val, batch_size=TRAIN_BATCH, drop_last=False, fixed_shape=True).epoch(0)]


def eval_pass(model, options, state, batches, compile):
    eval_step = make_eval_step(model, options, compile=compile)
    totals = init_metric_state(4, 8, options.auc_bins, "cuda")
    for b in batches:
        eval_step(state, b, totals)
    return totals


def coo_serving(model, compile):
    ds = serving_events(TRAIN_BATCH)
    return predict_split(model, ds, ds.norm(), TRAIN_BATCH, "cuda", fixed_shape=True,
                         compile=compile)


def float32_setup():
    """float32 (TF32 off), dropout and noise 0, the option file's widths at
    ``CUT_DEPTH``: the config, the options, the events and their batch of 16."""
    cfg = dataclasses.replace(cut_config("float32"), dropout=0.0, pixel_noise_std=0.0)
    options = fit_options()
    options.dropout, options.pixel_noise_std = 0.0, 0.0
    ds = InMemoryEvents(TRAIN_BATCH, SEED + 40)
    batch = to_device(Batcher(ds, batch_size=TRAIN_BATCH).build_batch(
        np.arange(TRAIN_BATCH)), "cuda")
    return cfg, options, ds, batch


def warm_graph(name, nice=0):
    """Compile graph ``name`` of ``WARM_GRAPHS`` into the compile cache and
    run it once, in a process of its own (``start_warming``) at the
    priority ``nice`` lowers it to: the bench's compiled rows through the
    bench's own functions, the others through the functions the checks
    below call, so that each cache key is the one they look up; float32
    graphs with phase 1's TF32 switch, bf16 ones under torch's default
    (``bench_precision``)."""
    os.nice(nice)
    enable_compile_cache()
    cuda = torch.device("cuda")
    if name.startswith("float32"):
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    if name.startswith("serve_b"):
        bench.serve_row(cut_config("bfloat16"), cuda, int(name[7:]), True)
    elif name.startswith("train_b"):
        bench.train_row(cut_config("bfloat16"), fit_options(), cuda, int(name[7:]), True, None)
    elif name == "eval_b16":
        options, model, state, _ = bf16_train_setup()
        eval_pass(model, options, state, eval_batches()[1], True)
    elif name == "coo_b16":
        coo_serving(serving_model("coo"), True)
    elif name == "remat_train_b16":
        options, model, state, batch = bf16_train_setup(remat_cnn=True)
        make_train_step(model, options, compile=True)(state, batch)
    else:
        cfg, options, ds, batch = float32_setup()
        model = TransformerCVN(cfg, generator=torch.Generator().manual_seed(SEED)).cuda()
        if name == "float32_predict":
            make_predict_step(model, compile=True)(batch, to_device(ds.norm(), "cuda"))
        else:
            state = create_train_state(model, options, ds.norm(), 100, seed=SEED)
            make_train_step(model, options, compile=True)(state, batch)
    torch.cuda.synchronize()
    print(json.dumps({"graph": name, "seconds": time.perf_counter() - t0,
                      "fx_graph_cache": cache_counts()}), flush=True)


def start_warming(work, names=WARM_GRAPHS, nice=0):
    """The graphs ``names`` of phases 15 and 17 and of the bench compiling
    at once, one process each (``warm_graph``, ``WARM_THREADS`` compile
    workers each), started; ``finish_warming`` waits for them.  Inductor
    spends a graph's compile in Python on one core (lowering, scheduling
    and code generation: 25 of a cut-depth serving graph's 36 s on the
    H100 host, Triton's own compiles 1.3 s), so the graphs compile side by
    side in about the time of the slowest, and the bench and the checks
    below load them from the cache.  The smoke starts the slowest beside
    phases 1-12, which leave most cores idle, and the rest beside phase
    13, all at a low priority."""
    enable_compile_cache()
    env = {**os.environ, "TORCHINDUCTOR_COMPILE_THREADS": str(WARM_THREADS)}
    here = os.path.dirname(os.path.abspath(__file__))
    logs = {name: os.path.join(work, f"warm_{name}.log") for name in names}
    procs = {}
    for name, path in logs.items():
        with open(path, "w") as out:
            procs[name] = subprocess.Popen(
                [sys.executable, "-c",
                 f"import chip_smoke; chip_smoke.warm_graph({name!r}, {nice})"],
                cwd=here, env=env, stdout=out, stderr=subprocess.STDOUT)
    return procs, logs, time.perf_counter()


def finish_warming(started, smi, beside=""):
    """Wait for ``start_warming``'s processes; raises with a process's
    output if it failed, and logs each one's compile and first call."""
    procs, logs, t0 = started
    try:
        deadline = time.monotonic() + WARM_TIMEOUT_S
        for proc in procs.values():
            proc.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        stop(procs.values())
    seconds = time.perf_counter() - t0
    readings = []
    for name, proc in procs.items():
        with open(logs[name]) as f:
            text = f.read()
        if proc.returncode != 0:
            raise RuntimeError(f"warming {name} exited {proc.returncode}:\n{text[-6000:]}")
        reading = json.loads([line for line in text.splitlines()
                              if line.startswith('{"graph"')][-1])
        readings.append(f"{name} {reading['seconds']:.1f} s")
    log(f"[compiled] {len(procs)} graphs at depth {CUT_DEPTH} compiled side by side "
        f"into the cache{beside}, all done {seconds:.1f} s after they started (each "
        f"process's compile and first call: {'; '.join(readings)}) ({smi})")


def run_bench(work):
    """``python -m dune_transformercvn_torch.bench`` as a subprocess on the
    option file at ``CUT_DEPTH``, with this process's compile cache;
    returns its JSON record."""
    with open(OPTION_FILE) as f:
        fields = json.load(f)
    fields.update({k: list(v) if isinstance(v, tuple) else v for k, v in CUT_DEPTH.items()})
    path = os.path.join(work, "cut_options.json")
    with open(path, "w") as f:
        json.dump(fields, f)
    free_memory()
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "dune_transformercvn_torch.bench",
                           "--options", path],
                          cwd=os.path.dirname(os.path.abspath(__file__)),
                          capture_output=True, text=True, timeout=BENCH_TIMEOUT_S)
    seconds = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or len(lines) != 1:
        raise RuntimeError(f"the bench exited {proc.returncode} with {len(lines)} stdout "
                           f"lines:\n{proc.stdout[-3000:]}\n{proc.stderr[-6000:]}")
    record = json.loads(lines[0])
    log(f"[bench] {json.dumps(record)}")
    assert "error" not in record and record["value"] > 0, record
    assert record["metric"] == "inference_events_per_second", record
    rows = [line for line in proc.stderr.splitlines() if line.startswith("# ")]
    log(f"[bench] depth {CUT_DEPTH}, {seconds:.1f} s, its compiled graphs from the "
        f"cache warmed above; rows: " + "; ".join(r[2:].split(" {")[0] for r in rows))
    return record


def compiled_agrees(eager, compiled, label):
    """bf16 predictions, compiled against eager: probabilities within
    FOLD_SHARE, argmax equal where eager's top two are more than
    2 FOLD_SHARE apart; returns the diffs and argmax agreements."""
    out = {}
    for key in ("event", "prong"):
        e, c = eager[f"{key}_probabilities"], compiled[f"{key}_probabilities"]
        assert np.isfinite(c).all() and c.shape == e.shape, (label, key)
        diff = float(np.abs(e - c).max())
        top = np.sort(e, -1)
        clear = top[:, -1] - top[:, -2] > 2 * FOLD_SHARE
        same = e.argmax(-1) == c.argmax(-1)
        assert diff <= FOLD_SHARE and same[clear].all(), (label, key, diff)
        out[key] = (diff, float(same.mean()))
    return out


def compiled_serving(smi):
    """bf16 ``predict_split`` compiled against eager at batch 16 and 64 on
    the bench's events and static shapes (its graphs from the cache);
    events/s of each in turns.  Returns K1's launches in the compiled
    passes."""
    model = serving_model()
    k1 = 0
    for b in bench.BATCH_SIZES:
        ds = serving_events(b)
        batches = math.ceil(len(ds) / b)

        def run(compile):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, counts = counted(lambda: predict_split(
                model, ds, ds.norm(), b, "cuda", fixed_shape=True, compile=compile))
            assert counts == (2 * batches, 0), counts
            return out, len(ds) / (time.perf_counter() - t0), counts[0]

        before = cache_counts()
        t0 = time.perf_counter()
        compiled, _, launches = run(True)
        first_s = time.perf_counter() - t0
        eager, _, _ = run(False)
        agree = compiled_agrees(eager, compiled, f"b{b}")
        rates = {True: [], False: []}
        for compile in (False, True, True, False):
            _, rate, launches_ = run(compile)
            rates[compile].append(rate)
            launches += launches_ if compile else 0
        k1 += launches
        log(f"[compiled] serving b{b} (bf16, {len(ds)} events, static shapes): first "
            f"compiled pass {first_s:.1f} s ({cache_reading(before)}); compiled "
            f"against eager: event prob diff {agree['event'][0]:.3g} (argmax agreement "
            f"{agree['event'][1]:.4f}), prong {agree['prong'][0]:.3g} "
            f"({agree['prong'][1]:.4f}); events/s in turns eager "
            f"{rates[False][0]:.1f}, compiled {rates[True][0]:.1f}, compiled "
            f"{rates[True][1]:.1f}, eager {rates[False][1]:.1f}: compiled/eager "
            f"{statistics.mean(rates[True]) / statistics.mean(rates[False]):.2f}x; K1 "
            f"{launches} in the compiled passes, 2 a batch ({smi})")
    del model
    free_memory()
    return k1


def compiled_training(smi):
    """The option file's train step compiled, bf16, batch 16, on the
    bench's batch (its graph from the cache): warm-up and timed steps, peak
    memory; then one compiled eval pass against eager's.  Returns K1's
    launches."""
    options, model, state, batch = bf16_train_setup()
    step = make_train_step(model, options, compile=True)
    before = cache_counts()
    t0 = time.perf_counter()
    first, counts = counted(lambda: step(state, batch))
    first_s = time.perf_counter() - t0
    train_cache = cache_reading(before)
    _, warm = counted(lambda: [step(state, batch) for _ in range(COMPILED_WARMUP - 1)])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    metrics, timed = counted(lambda: [step(state, batch) for _ in range(COMPILED_STEPS)][-1])
    ms = 1e3 * (time.perf_counter() - t0) / COMPILED_STEPS
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    assert (counts, warm, timed) == ((2, 0), (2 * (COMPILED_WARMUP - 1), 0),
                                     (2 * COMPILED_STEPS, 0)), (counts, warm, timed)
    losses = (float(first["train_loss"]), float(metrics["train_loss"]))
    assert all(math.isfinite(v) for v in losses + (float(metrics["grad_norm"]),)), metrics

    val, val_batches = eval_batches()
    before = cache_counts()
    t0 = time.perf_counter()
    totals, eval_counts = counted(lambda: eval_pass(model, options, state, val_batches, True))
    eval_s = time.perf_counter() - t0
    eval_cache = cache_reading(before)
    eager_totals = eval_pass(model, options, state, val_batches, False)
    assert eval_counts == (2 * len(val_batches), 0), eval_counts
    assert float(totals["event_count"]) == float(eager_totals["event_count"]) == len(val)
    got, want = finalize_metrics(totals), finalize_metrics(eager_totals)
    assert math.isfinite(got["val_epoch_AUC"]) and math.isfinite(got["val_loss"]), got
    log(f"[compiled] train step, bf16, batch 16 (the option file's dropout and noise): "
        f"first call {first_s:.1f} s ({train_cache}), then "
        f"{ms:.2f} ms/step ({COMPILED_STEPS} after {COMPILED_WARMUP}), "
        f"{TRAIN_BATCH * 1e3 / ms:.2f} events/s, peak {peak:.2f} GiB; train_loss "
        f"{losses[0]:.5f} -> {losses[1]:.5f}; compiled eval pass over {len(val)} events "
        f"({len(val_batches)} batches, {eval_s:.1f} s, {eval_cache}): val AUC "
        f"{got['val_epoch_AUC']:.4f}, val loss {got['val_loss']:.5f} (eager "
        f"{want['val_epoch_AUC']:.4f}, {want['val_loss']:.5f}) ({smi})")
    del model, state
    free_memory()
    return counts[0] + warm[0] + timed[0] + eval_counts[0]


def compiled_coo(smi):
    """The coo family's forward compiled at batch 16, bf16, K2 inside the
    graph: against eager on the bench's b16 events; returns K2's launches
    in the compiled pass."""
    model = serving_model("coo")
    batches = math.ceil(bench.SERVE_EVENTS[TRAIN_BATCH] / TRAIN_BATCH)
    before = cache_counts()
    t0 = time.perf_counter()
    compiled, counts = counted(lambda: coo_serving(model, True))
    first_s = time.perf_counter() - t0
    eager = coo_serving(model, False)
    assert counts == (0, 2 * batches), counts
    agree = compiled_agrees(eager, compiled, "coo b16")
    log(f"[compiled] coo serving b16 (bf16, {bench.SERVE_EVENTS[TRAIN_BATCH]} events): "
        f"first compiled pass {first_s:.1f} s ({cache_reading(before)}); against eager: "
        f"event prob diff {agree['event'][0]:.3g}, prong {agree['prong'][0]:.3g}; K2 "
        f"{counts[1]} in the compiled pass, 2 a batch, K1 0 ({smi})")
    del model
    free_memory()
    return counts[1]


def compiled_float32_checks(smi):
    """float32, TF32 off, dropout and noise 0, the option file's widths at
    ``CUT_DEPTH``: the compiled predict step's probabilities and the
    compiled train step's first loss and gradient norm against eager's at
    batch 16, within PATH_TOL.  Returns K1's launches in the compiled
    steps."""
    cfg, options, ds, batch = float32_setup()
    norm = to_device(ds.norm(), "cuda")
    models = [TransformerCVN(cfg, generator=torch.Generator().manual_seed(SEED)).cuda()
              for _ in range(2)]
    before = cache_counts()
    t0 = time.perf_counter()
    got, counts = counted(lambda: make_predict_step(models[1], compile=True)(batch, norm))
    predict_s = time.perf_counter() - t0
    want = make_predict_step(models[0])(batch, norm)
    assert counts == (2, 0), counts
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **PATH_TOL)
    k1, firsts = counts[0], []
    for model, compile in zip(models, (False, True)):
        state = create_train_state(model, options, ds.norm(), 100, seed=SEED)
        step = make_train_step(model, options, compile=compile)
        t0 = time.perf_counter()
        metrics, counts = counted(lambda: step(state, batch))
        firsts.append((float(metrics["train_loss"]), float(metrics["grad_norm"]),
                       time.perf_counter() - t0))
        assert counts == (2, 0), counts
        k1 += counts[0] if compile else 0
    (loss, norm_e, _), (loss_c, norm_c, train_s) = firsts
    np.testing.assert_allclose([loss_c, norm_c], [loss, norm_e], **PATH_TOL)
    log(f"[compiled] float32 checks, batch 16, depth {CUT_DEPTH}: predict "
        f"probabilities within {PATH_TOL} of eager (max diff event "
        f"{max_diff(got[0], want[0]):.3g}, prong {max_diff(got[1], want[1]):.3g}); the "
        f"first train step's loss {loss_c:.6f} against eager's {loss:.6f}, grad_norm "
        f"{norm_c:.5f} against {norm_e:.5f}; first calls {predict_s:.1f} s (predict), "
        f"{train_s:.1f} s (train step), {cache_reading(before)} ({smi})")
    del models
    free_memory()
    return k1


def check_compiled(smi, warmed=False):
    """Phase 15: the compiled steps; returns the K1 and K2 launches of the
    compiled paths.  ``warmed``: the cache holds the graphs already
    (``start_warming`` / ``finish_warming`` ran), else they compile here
    first."""
    enable_compile_cache()
    work = tempfile.mkdtemp(prefix="chip_smoke_compiled_")
    try:
        if not warmed:
            finish_warming(start_warming(work), smi)
        run_bench(work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    with bench_precision():
        k1 = compiled_serving(smi) + compiled_training(smi)
        k2 = compiled_coo(smi)
    k1 += compiled_float32_checks(smi)
    return k1, k2


# ---------------------------------------------------------------------------
# phase 16
# ---------------------------------------------------------------------------

def host_state(model, optimizer):
    """A model's parameters and buffers and a graph-safe AdamW's moments and
    count, copied to the host."""
    out = {f"model.{n}": t.detach().cpu() for n, t in model.state_dict().items()}
    for i, slots in enumerate(optimizer.state.values()):
        out.update({f"adamw.{i}.{k}": t.detach().cpu() for k, t in slots.items()})
    out["adamw.count"] = optimizer.count.cpu()
    return out


def relative_gap(got, want):
    """The largest ``|got - want|`` of each tensor over its largest
    ``|want|``, the worst tensor's, and its name."""
    worst, name = 0.0, None
    for key, w in want.items():
        w, g = w.double(), got[key].double()
        gap = float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
        if gap > worst:
            worst, name = gap, key
    return worst, name


def graph_train_batches(cfg, seed, steps, batch_size=TRAIN_BATCH):
    """``steps`` batches of ``batch_size`` events in one static shape, on
    the card."""
    ds = InMemoryEvents(batch_size * steps, seed)
    batcher = Batcher(ds, batch_size=batch_size, fixed_shape=True)
    return ds, [to_device(b, "cuda") for b in batcher.epoch(0)]


def stack_groups(batches, k):
    return [{n: torch.stack([b[n] for b in batches[i:i + k]]) for n in batches[0]}
            for i in range(0, len(batches), k)]


def kernel_launches_in(prof, name):
    return sum(e.count for e in prof.key_averages() if name in e.key)


def graph_training(smi, flags=None, profiled=True):
    """The option file's dense network whole, bf16, b16, its dropout and
    noise (``flags``: model config fields, a memory recipe):
    ``GRAPH_K`` x ``GRAPH_REPLAYS`` steps as replays of one CUDA graph of
    K steps against as many eager steps from the same state (both with the
    graph-safe AdamW), then (``profiled``) one more replay under
    ``torch.profiler``; returns K1's launches."""
    options = Options.load(OPTION_FILE)
    cfg = dataclasses.replace(production_config("bfloat16"), **(flags or {}))
    tag = "+".join(flags or {}) or "plain"
    assert (cfg.dropout, cfg.pixel_noise_std) == (0.1, 0.001) and options.optimizer == "AdamW"
    k, steps = GRAPH_K, GRAPH_K * GRAPH_REPLAYS
    ds, batches = graph_train_batches(cfg, SEED + 50, steps)
    start = TransformerCVN(cfg, generator=torch.Generator().manual_seed(SEED))
    free_memory()

    model = copy.deepcopy(start).cuda()
    state = create_train_state(model, options, ds.norm(), 100, seed=SEED, graph=True)
    step = make_train_step(model, options)
    torch.cuda.reset_peak_memory_stats()
    eager = []
    untimed = steps - GRAPH_TIMED * k

    def eager_steps():
        for i, batch in enumerate(batches):
            if i == untimed:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            eager.append(step(state, batch))
        host_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        return host_s, time.perf_counter() - t0

    (eager_host_s, eager_s), eager_counts = counted(eager_steps)
    eager_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    assert eager_counts == (2 * steps, 0), eager_counts
    want = host_state(model, state.optimizer)
    want_metrics = {n: torch.stack([m[n].float() for m in eager]).cpu() for n in eager[0]}
    del model, state, step, eager
    free_memory()

    model = copy.deepcopy(start).cuda()
    state = create_train_state(model, options, ds.norm(), 100, seed=SEED, graph=True)
    step = make_train_step(model, options, graph=True, steps_per_dispatch=k)
    groups = stack_groups(batches, k)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    first, first_counts = counted(lambda: step(state, groups[0]))
    capture_s = time.perf_counter() - t0
    graph_reserved = torch.cuda.memory_reserved() / 2 ** 30
    (captured,) = step.graphs.graphs.values()
    assert captured.launches == [2 * k, 0], captured.launches
    assert first_counts == (2 * k + 2 * k, 0), first_counts   # the warm-up's and a replay's

    def replays():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = [step(state, group) for group in groups[1:]]
        host_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        return out, host_s, time.perf_counter() - t0

    (rest, graph_host_s, graph_s), counts = counted(replays)
    assert counts == (2 * k * (GRAPH_REPLAYS - 1), 0), counts
    graph_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    got = host_state(model, state.optimizer)
    got_metrics = {n: torch.cat([m[n] for m in [first] + rest]).cpu() for n in first}
    assert state.step == steps and got_metrics.keys() == want_metrics.keys()
    for value in got_metrics.values():
        assert torch.isfinite(value).all(), got_metrics
    eager_ms, graph_ms = (1e3 * s / (GRAPH_TIMED * k) for s in (eager_s, graph_s))
    log(f"[graph] dense train step ({tag}), full depth, bf16, b{TRAIN_BATCH}: ms/step over "
        f"the last {GRAPH_TIMED * k} of {steps} steps: eager {eager_ms:.2f} (host dispatch "
        f"{1e3 * eager_host_s / (GRAPH_TIMED * k):.2f}), {k}-step graph {graph_ms:.2f} (host "
        f"{1e3 * graph_host_s / (GRAPH_TIMED * k):.3f}): {eager_ms / graph_ms:.2f}x; the "
        f"first graph call (warm-up of {k} steps, capture, replay) {capture_s:.2f} s; peak "
        f"memory eager {eager_peak:.2f} GiB, graph {graph_peak:.2f} GiB allocated (warm-up "
        f"included), {graph_reserved:.2f} GiB reserved after the capture; K1 "
        f"{captured.launches[0]} a replay ({smi})")
    exact = all(torch.equal(got[n], want[n]) for n in want) and all(
        torch.equal(got_metrics[n], want_metrics[n]) for n in want_metrics)
    if exact:
        agreement = "bit for bit"
    else:
        gap, where = relative_gap({**got, **got_metrics}, {**want, **want_metrics})
        cause = graph_gap_cause(start, options, ds, batches[:k])
        log(f"[graph] graph against eager: largest relative gap {gap:.3g} ({where}); "
            f"cause: {cause}")
        assert gap <= GRAPH_TOL, (gap, where, cause)
        agreement = (f"not bit for bit: largest relative gap {gap:.3g} ({where}), within "
                     f"2^-7; cause: {cause}")
    assert graph_reserved < 2 * eager_peak, (graph_reserved, eager_peak)
    log(f"[graph] dense train step ({tag}): {GRAPH_REPLAYS} replays of the {k}-step graph "
        f"against {steps} eager steps from the same state (dropout {cfg.dropout}, noise "
        f"{cfg.pixel_noise_std}): metrics, parameters, running statistics and AdamW's "
        f"moments {agreement}; train_loss {float(got_metrics['train_loss'][0]):.5f} -> "
        f"{float(got_metrics['train_loss'][-1]):.5f}")
    if not profiled:
        del model, state, step, groups, batches
        free_memory()
        return first_counts[0] + counts[0] + eager_counts[0]
    # one replay under the profiler, last in the phase: CUPTI stays attached
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, traced_counts = counted(lambda: step(state, groups[0]))
    traced = kernel_launches_in(prof, "densify_kernel")
    assert traced == traced_counts[0] == 2 * k, (traced, traced_counts)
    events = prof.key_averages()
    launch_ms = sum(e.cpu_time_total for e in events if e.key == "cudaGraphLaunch") / 1e3
    kernel_ms = sum(e.self_device_time_total for e in events) / 1e3
    log(f"[graph] torch.profiler over one replay of the {k}-step train graph: {traced} "
        f"densify_kernel launches, the count's {traced_counts[0]}; kernel time "
        f"{kernel_ms / k:.2f} ms a step; cudaGraphLaunch held the host "
        f"{launch_ms / k:.2f} ms a step ({smi})")
    del model, state, step, groups, batches
    free_memory()
    return first_counts[0] + counts[0] + eager_counts[0] + traced_counts[0]


def graph_gap_cause(start, options, ds, batches):
    """Why a graph's steps and eager's differ: two eager runs of the same
    steps from the same state, against each other."""
    runs = []
    for _ in range(2):
        model = copy.deepcopy(start).cuda()
        state = create_train_state(model, options, ds.norm(), 100, seed=SEED, graph=True)
        step = make_train_step(model, options)
        for batch in batches:
            step(state, batch)
        runs.append(host_state(model, state.optimizer))
        del model, state
        free_memory()
    gap, where = relative_gap(*runs)
    if gap:
        return (f"eager is not reproducible itself (two eager runs of {len(batches)} steps "
                f"differ by {gap:.3g} relative at {where}: kernels that sum in no fixed "
                "order)")
    return "eager reproduces itself bit for bit; the captured kernels differ from eager's"


def probabilities_equal(got, want, label):
    """Serving through a graph against eager: the same kernels on the same
    shapes, so equal; returns "bit for bit" or the largest difference
    within FOLD_SHARE with argmax equal where eager's is clear."""
    if all(np.array_equal(got[k], want[k]) for k in want):
        return "bit for bit"
    agree = compiled_agrees(want, got, label)
    return (f"within {FOLD_SHARE:g}: event {agree['event'][0]:.3g}, prong "
            f"{agree['prong'][0]:.3g}")


def graph_serving(smi, embedder, sizes):
    """``predict_split(graph=True)`` against eager on the option file's
    network whole, bf16, static shapes; events/s in turns.  Returns the
    kernels' launches in the graph passes."""
    model = TransformerCVN(family_config(embedder),
                           generator=torch.Generator().manual_seed(SEED)).cuda()
    launches = np.zeros(2, np.int64)
    for b, n in sizes:
        ds = InMemoryEvents(n, SEED + 60 + b)
        batches = math.ceil(n / b)

        def run(graph, capture=False):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, counts = counted(lambda: predict_split(
                model, ds, ds.norm(), b, "cuda", fixed_shape=True, graph=graph))
            forwards = batches + capture       # a capture's warm-up forward
            want = (0, 2 * forwards) if embedder == "coo" else (2 * forwards, 0)
            assert counts == want, (counts, want)
            return out, n / (time.perf_counter() - t0), np.array(counts)

        eager, _, _ = run(False)
        t0 = time.perf_counter()
        graph, _, counts = run(True, capture=True)
        first_s = time.perf_counter() - t0
        launches += counts
        agreement = probabilities_equal(graph, eager, f"{embedder} b{b}")
        rates = {True: [], False: []}
        for graphed in (False, True, True, False):
            _, rate, counts = run(graphed)
            rates[graphed].append(rate)
            launches += counts if graphed else 0
        log(f"[graph] {embedder} serving b{b}, full depth, bf16, {n} events, static shapes: "
            f"graph against eager {agreement}; first graph pass (its capture) {first_s:.2f} "
            f"s, later passes replay it; events/s in turns eager {rates[False][0]:.1f}, "
            f"graph {rates[True][0]:.1f}, "
            f"graph {rates[True][1]:.1f}, eager {rates[False][1]:.1f}: graph/eager "
            f"{statistics.mean(rates[True]) / statistics.mean(rates[False]):.2f}x ({smi})")
    del model
    free_memory()
    return launches


def graph_coo_training(smi):
    """The coo family whole, bf16, b16: ``GRAPH_COO_STEPS`` steps as replays
    of the one-step graph against eager steps; returns K2's launches."""
    options = Options.load(OPTION_FILE)
    cfg = family_config("coo")
    ds, batches = graph_train_batches(cfg, SEED + 70, GRAPH_COO_STEPS)
    start = TransformerCVN(cfg, generator=torch.Generator().manual_seed(SEED))
    results, launches = [], 0
    for graph in (False, True):
        model = copy.deepcopy(start).cuda()
        state = create_train_state(model, options, ds.norm(), 100, seed=SEED, graph=True)
        step = make_train_step(model, options, graph=graph)
        metrics, counts = counted(lambda: [step(state, b) for b in batches])
        assert counts == (0, 2 * GRAPH_COO_STEPS + (2 if graph else 0)), counts
        launches += counts[1]
        if graph:
            (captured,) = step.graphs.graphs.values()
            assert captured.launches == [0, 2], captured.launches
        results.append(({n: torch.stack([m[n].float() for m in metrics]).cpu()
                          for n in metrics[0]}, host_state(model, state.optimizer)))
        del model, state, step
        free_memory()
    (want_m, want), (got_m, got) = results
    gap, where = relative_gap({**got, **got_m}, {**want, **want_m})
    assert gap <= GRAPH_TOL, (gap, where)
    log(f"[graph] coo train step, full depth, bf16, b{TRAIN_BATCH}: {GRAPH_COO_STEPS} "
        f"replays of the one-step graph (K2 2 a replay) against eager: "
        f"{'bit for bit' if gap == 0 else f'largest relative gap {gap:.3g} ({where})'}; "
        f"train_loss {float(got_m['train_loss'][-1]):.5f} ({smi})")
    return launches


def graph_trainer(smi):
    """``Trainer(graph=True)`` on the option file at ``CUT_DEPTH``,
    ``steps_per_dispatch`` 4: a fit with validations and checkpoints, a
    fresh Trainer resumed from the first checkpoint equal to the snapshot
    bit for bit and fit to the same step.  Returns K1's launches."""
    val_batches = math.ceil(FIT_VAL_EVENTS / TRAIN_BATCH)
    run_dir = tempfile.mkdtemp(prefix="chip_smoke_graph_trainer_")
    try:
        snapshot = {}

        def snap(step, metrics):
            if step == GRAPH_FIT_EVAL:
                snapshot.update(to_host(trainer.state.state_dict()))

        def options():
            opts = fit_options()
            opts.steps_per_dispatch = GRAPH_K
            return opts

        trainer = Trainer(options(), run_dir=run_dir, callbacks=[snap], graph=True,
                          log_every_n_steps=GRAPH_K, datasets=fit_datasets(), verbose=False)
        t0 = time.perf_counter()
        result, counts = counted(lambda: trainer.fit(max_steps=GRAPH_FIT_STEPS,
                                                     eval_interval=GRAPH_FIT_EVAL))
        seconds = time.perf_counter() - t0
        evals = GRAPH_FIT_STEPS // GRAPH_FIT_EVAL
        # the warm-ups launch too: a K-step train graph's and the eval graph's
        warm = 2 * GRAPH_K + 2
        assert counts == (2 * (GRAPH_FIT_STEPS + evals * val_batches) + warm, 0), counts
        launches = counts[0]
        losses = [v for _, v in read_history(run_dir)["train_loss"]]
        assert losses and all(math.isfinite(v) for v in losses), losses
        assert math.isfinite(result["val_epoch_AUC"]), result
        final = to_host(trainer.state.state_dict())
        assert snapshot["step"] == GRAPH_FIT_EVAL and final["step"] == GRAPH_FIT_STEPS
        del trainer
        free_memory()

        fresh = Trainer(options(), run_dir=run_dir, graph=True, log_every_n_steps=GRAPH_K,
                        datasets=fit_datasets(), verbose=False)
        fresh.resume(os.path.join(run_dir, "checkpoints", f"step_{GRAPH_FIT_EVAL}"))
        assert_state_equal(to_host(fresh.state.state_dict()), snapshot)
        count = int(fresh.state.optimizer.count)
        assert count == GRAPH_FIT_EVAL, count
        _, counts = counted(lambda: fresh.fit(max_steps=GRAPH_FIT_STEPS))
        launches += counts[0]
        resumed = to_host(fresh.state.state_dict())
        same = all(torch.equal(resumed["model"][n], t) for n, t in final["model"].items())
        log(f"[graph] Trainer(graph=True), steps_per_dispatch {GRAPH_K}, depth {CUT_DEPTH}, "
            f"bf16, b{TRAIN_BATCH}: fit {GRAPH_FIT_STEPS} steps + {evals} validations in "
            f"{seconds:.2f} s (captures included), train_loss {losses[-1]:.5f}, val AUC "
            f"{result['val_epoch_AUC']:.4f}; resume(step_{GRAPH_FIT_EVAL}) equal to the "
            f"snapshot bit for bit (AdamW's count {count}); fit on to "
            f"step {GRAPH_FIT_STEPS}: parameters "
            f"{'equal to the first fit bit for bit' if same else 'not bit-equal to the first fit'}"
            f"; K1 {launches} ({smi})")
        del fresh
        free_memory()
        return launches
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)


def graph_compiled(smi):
    """``graph=True`` with ``compile=True`` at ``CUT_DEPTH``: phase 15's
    train_b16 and serve_b16 graphs from the cache, captured.  Compiles
    nothing new; returns K1's launches."""
    options, model, eager_state, batch = bf16_train_setup()
    state = create_train_state(model, options, {k: v.cpu() for k, v in eager_state.norm.items()},
                               100, seed=SEED, graph=True)
    del eager_state
    step = make_train_step(model, options, compile=True, graph=True)
    before = cache_counts()
    metrics, counts = counted(lambda: [step(state, batch) for _ in range(3)][-1])
    assert counts == (2 + 2 * 3, 0), counts
    assert math.isfinite(float(metrics["train_loss"])), metrics
    train_cache = cache_reading(before)
    ds = serving_events(TRAIN_BATCH)
    serve = serving_model()
    mid = cache_counts()
    out, serve_counts = counted(lambda: predict_split(
        serve, ds, ds.norm(), TRAIN_BATCH, "cuda", fixed_shape=True, compile=True,
        graph=True))
    eager = predict_split(serve, ds, ds.norm(), TRAIN_BATCH, "cuda", fixed_shape=True)
    agree = compiled_agrees(eager, out, "compiled graph b16")
    misses = cache_counts()[1] - before[1]
    assert misses == 0, (train_cache, cache_reading(mid))
    log(f"[graph] graph=True with compile=True, depth {CUT_DEPTH}, bf16, b{TRAIN_BATCH}: "
        f"train step 3 calls ({train_cache}), loss {float(metrics['train_loss']):.5f}; "
        f"predict_split ({cache_reading(mid)}) against eager: event prob diff "
        f"{agree['event'][0]:.3g}, prong {agree['prong'][0]:.3g}; K1 {counts[0]} + "
        f"{serve_counts[0]} ({smi})")
    del model, serve, state, step
    free_memory()
    return counts[0] + serve_counts[0]


def check_graphs(smi, compiled=True):
    """Phase 16: CUDA graphs (``graph=True``); returns the K1 and K2
    launches of the graph paths.  ``compiled``: with the graphs of phase
    15's cache (``graph_compiled``)."""
    k1 = int(graph_serving(smi, "dense", GRAPH_SERVE_EVENTS)[0])
    k2 = int(graph_serving(smi, "coo", GRAPH_SERVE_EVENTS[:1])[1])
    k2 += graph_coo_training(smi)
    k1 += graph_trainer(smi)
    if compiled:
        with bench_precision():
            k1 += graph_compiled(smi)
    # the full-depth train graph last: its profiler reading ends the phase
    k1 += graph_training(smi)
    return k1, k2


# ---------------------------------------------------------------------------
# phase 17
# ---------------------------------------------------------------------------

def graph_against_eager(cfg, options, ds, batches, k, per_step):
    """``batches`` as eager steps and as replays of a ``k``-step graph
    from the same start (the graph-safe optimizer in both).  Asserts the
    kernels' launches (``per_step``: K1's and K2's a step, a recompute's
    included) and the two runs equal bit for bit or within ``GRAPH_TOL``.
    Returns (agreement, eager ms/step, graph ms/step, eager peak GiB,
    graph peak GiB, (K1, K2) launches of both runs); ms/step over every
    call after the first (the graph's first: warm-up, capture, replay)."""
    start = TransformerCVN(cfg, generator=torch.Generator().manual_seed(SEED))
    calls = {False: batches, True: stack_groups(batches, k) if k > 1 else batches}
    runs, launches = [], np.zeros(2, np.int64)
    for graph in (False, True):
        model = copy.deepcopy(start).cuda()
        state = create_train_state(model, options, ds.norm(), 100, seed=SEED, graph=True)
        step = (make_train_step(model, options, graph=True, steps_per_dispatch=k)
                if graph else make_train_step(model, options))
        torch.cuda.reset_peak_memory_stats()
        first, first_counts = counted(lambda: step(state, calls[graph][0]))

        def rest():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = [step(state, c) for c in calls[graph][1:]]
            torch.cuda.synchronize()
            return out, time.perf_counter() - t0

        (out, seconds), counts = counted(rest)
        steps_per_call = k if graph else 1
        want = tuple(n * steps_per_call * (len(calls[graph]) - 1) for n in per_step)
        assert counts == want, (counts, want)
        if graph:
            (captured,) = step.graphs.graphs.values()
            assert captured.launches == [n * k for n in per_step], captured.launches
            # the first call: the warm-up's k steps and one replay
            assert first_counts == tuple(2 * n * k for n in per_step), first_counts
        launches += np.array(first_counts) + np.array(counts)
        metrics = [first] + out
        stacked = {n: (torch.cat if graph and k > 1 else torch.stack)(
            [m[n].float() for m in metrics]).cpu() for n in first}
        assert state.step == len(batches) and int(state.optimizer.count) == len(batches)
        runs.append((stacked, host_state(model, state.optimizer),
                     1e3 * seconds / (steps_per_call * (len(calls[graph]) - 1)),
                     torch.cuda.max_memory_allocated() / 2 ** 30))
        del model, state, step, first, out
        free_memory()
    (want_m, want, eager_ms, eager_peak), (got_m, got, graph_ms, graph_peak) = runs
    for value in got_m.values():
        assert torch.isfinite(value).all(), got_m
    gap, where = relative_gap({**got, **got_m}, {**want, **want_m})
    if gap == 0:
        agreement = "bit for bit"
    else:
        cause = graph_gap_cause(start, options, ds, batches[:k])
        assert gap <= GRAPH_TOL, (gap, where, cause)
        agreement = f"largest relative gap {gap:.3g} ({where}), within 2^-7; cause: {cause}"
    return agreement, eager_ms, graph_ms, eager_peak, graph_peak, tuple(int(n) for n in launches)


def chain_graphs(smi):
    """Each of the seven optax chains at ``CUT_DEPTH``: ``CHAIN_REPLAYS``
    replays of a ``CHAIN_K``-step graph against as many eager steps.
    Returns K1's launches."""
    from dune_transformercvn_torch.train.optimizer import CHAINS

    cfg = cut_config("bfloat16")
    steps = CHAIN_K * CHAIN_REPLAYS
    ds, batches = graph_train_batches(cfg, SEED + 80, steps)
    readings, k1 = [], 0
    for name in CHAINS:
        options = fit_options()
        options.optimizer = name
        agreement, eager_ms, graph_ms, _, _, counts = graph_against_eager(
            cfg, options, ds, batches, CHAIN_K, (2, 0))
        k1 += counts[0]
        readings.append(f"{name} {agreement}, eager {eager_ms:.2f} / graph {graph_ms:.2f} "
                        "ms/step")
    log(f"[recipes] the optax chains' train steps, depth {CUT_DEPTH}, bf16, b{TRAIN_BATCH}, "
        f"dropout {cfg.dropout}: {CHAIN_REPLAYS} replays of a {CHAIN_K}-step graph against "
        f"{steps} eager steps (metrics, parameters, statistics, slots and count): "
        + "; ".join(readings) + f" ({smi})")
    return k1


def remat_embedder_graphs(smi):
    """``remat_embedder`` at ``CUT_DEPTH``, dense and coo: ``RECIPE_REPLAYS``
    replays of a ``RECIPE_K``-step graph against eager.  The coo stem lies
    inside the rematted embedder, so the backward's recompute launches K2
    again: 4 a step.  Returns the K1 and K2 launches."""
    options = fit_options()
    steps = RECIPE_K * RECIPE_REPLAYS
    launches = np.zeros(2, np.int64)
    for embedder, per_step in (("dense", (2, 0)), ("coo", (0, 4))):
        cfg = dataclasses.replace(cut_config("bfloat16"), embedder=embedder,
                                  remat_embedder=True)
        ds, batches = graph_train_batches(cfg, SEED + 90, steps)
        agreement, eager_ms, graph_ms, eager_peak, graph_peak, counts = graph_against_eager(
            cfg, options, ds, batches, RECIPE_K, per_step)
        launches += counts
        log(f"[recipes] {embedder} train step with remat_embedder, depth {CUT_DEPTH}, bf16, "
            f"b{TRAIN_BATCH}: {RECIPE_REPLAYS} replays of a {RECIPE_K}-step graph against "
            f"{steps} eager steps {agreement}; ms/step eager {eager_ms:.2f}, graph "
            f"{graph_ms:.2f}; peak {eager_peak:.2f} / {graph_peak:.2f} GiB; "
            f"{'K2' if embedder == 'coo' else 'K1'} {max(per_step)} a step "
            f"({counts} in all) ({smi})")
    return launches


def compiled_remat(smi):
    """The compiled ``remat_cnn`` train step at ``CUT_DEPTH`` (its graph
    from the cache, warmed beside phases 13 and 10) beside the compiled plain step
    (phase 15's): first call, ms/step and peak memory.  Returns K1's
    launches."""
    readings, k1 = [], 0
    for flags in ({}, {"remat_cnn": True}):
        options, model, state, batch = bf16_train_setup(**flags)
        step = make_train_step(model, options, compile=True)
        before = cache_counts()
        t0 = time.perf_counter()
        _, first = counted(lambda: step(state, batch))
        first_s = time.perf_counter() - t0
        cache = cache_reading(before)
        _, warm = counted(lambda: [step(state, batch) for _ in range(REMAT_COMPILED_WARMUP)])
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        metrics, timed = counted(lambda: [step(state, batch)
                                          for _ in range(REMAT_COMPILED_STEPS)][-1])
        ms = 1e3 * (time.perf_counter() - t0) / REMAT_COMPILED_STEPS
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        assert (first, warm, timed) == ((2, 0), (2 * REMAT_COMPILED_WARMUP, 0),
                                        (2 * REMAT_COMPILED_STEPS, 0)), (first, warm, timed)
        assert math.isfinite(float(metrics["train_loss"])), metrics
        k1 += first[0] + warm[0] + timed[0]
        readings.append(f"{'+'.join(flags) or 'plain'}: first call {first_s:.1f} s ({cache}), "
                        f"{ms:.2f} ms/step, peak {peak:.2f} GiB")
        del model, state, step
        free_memory()
    log(f"[recipes] compiled train step, depth {CUT_DEPTH}, bf16, b{TRAIN_BATCH} "
        f"({REMAT_COMPILED_STEPS} steps after {REMAT_COMPILED_WARMUP + 1}): "
        + "; ".join(readings) + f" ({smi})")
    return k1


def sdxl_chunk_graph(smi):
    """The sdxl family at full width, ``embedder_chunk`` 16, bf16, b16,
    static shapes: ``SDXL_GRAPH_STEPS`` + 1 replays of the one-step graph
    against as many eager steps.  Returns K1's launches."""
    options = Options.load(OPTION_FILE)
    cfg = family_config("sdxl", embedder_chunk=SDXL_GRAPH_CHUNK)
    ds, batches = graph_train_batches(cfg, SEED + 100, SDXL_GRAPH_STEPS + 1)
    agreement, eager_ms, graph_ms, eager_peak, graph_peak, counts = graph_against_eager(
        cfg, options, ds, batches, 1, (2, 0))
    log(f"[recipes] sdxl train step, chunk {SDXL_GRAPH_CHUNK}, full width, bf16, "
        f"b{TRAIN_BATCH}, static shapes ({batches[0]['slot_batch'].shape[0]} prong slots): "
        f"the one-step graph against eager {agreement}; ms/step over {SDXL_GRAPH_STEPS} "
        f"steps eager {eager_ms:.2f}, graph {graph_ms:.2f}; peak {eager_peak:.2f} / "
        f"{graph_peak:.2f} GiB ({smi})")
    return counts[0]


def check_recipes(smi, compiled=True):
    """Phase 17: the memory recipes and the optax chains in one dispatch;
    returns the K1 and K2 launches of its paths.  ``compiled``: with the
    compiled ``remat_cnn`` step from phase 15's cache (the smoke runs the
    rest in a process of its own, ``side_child``)."""
    k1 = chain_graphs(smi)
    k1_embedder, k2 = remat_embedder_graphs(smi)
    k1 += int(k1_embedder)
    k1 += sdxl_chunk_graph(smi)
    k1 += graph_training(smi, {"remat_cnn": True}, profiled=False)
    if compiled:
        with bench_precision():
            k1 += compiled_remat(smi)
    return k1, int(k2)


# ---------------------------------------------------------------------------
# phase 19
# ---------------------------------------------------------------------------

def check_sustained(smi):
    """Phase 19: ``sustained_train.run`` on the twin's events at
    ``CUT_DEPTH`` as ``SUSTAINED_K``-step CUDA graphs; returns K1's
    launches.  Every logged loss finite, K1 twice a step and a validation
    batch (plus the graphs' warm-ups before their captures), K2 never, a
    window logged in each validation interval, ``val_epoch_AUC`` and the
    train metrics at each validation, and the mean loss logged over the
    last validation interval below the first's."""
    work = tempfile.mkdtemp(prefix="chip_smoke_sustained_")
    try:
        record, counts = counted(lambda: sustained_train.run(
            steps=SUSTAINED_STEPS, events=SUSTAINED_EVENTS, eval_interval=SUSTAINED_EVAL,
            batch_size=TRAIN_BATCH, graph=True, steps_per_dispatch=SUSTAINED_K,
            device="cuda", out=os.path.join(work, "record.json"), options=fit_options(),
            workdir=work, log_every_n_steps=SUSTAINED_K, verbose=False))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    steps, val_batches = record["steps"], record["validation_batches"]
    expected = 2 * (steps + val_batches) + record["k1_warmup_launches"]
    assert steps == SUSTAINED_STEPS, steps
    assert counts == (expected, 0) and counts[0] == record["k1_launches"], (counts, expected)
    losses = [(c["step"], c["train_loss"]) for c in record["train_loss_curve"]]
    assert losses and all(math.isfinite(v) for _, v in losses), losses
    evals = list(range(SUSTAINED_EVAL, SUSTAINED_STEPS + 1, SUSTAINED_EVAL))
    assert [c["step"] for c in record["val_auc_curve"]] == evals, record["val_auc_curve"]
    assert all(math.isfinite(c["val_epoch_AUC"]) for c in record["val_auc_curve"])
    # a window is logged in each validation interval, and train metrics at
    # each validation (the window read there is empty, so it logs no rate:
    # its steps' events count in the window read one dispatch earlier)
    window_steps = [w["step"] for w in record["window_events_per_second"]]
    for start, end in zip([0] + evals, evals):
        assert any(start < s <= end for s in window_steps), (start, end, window_steps)
    assert set(evals) <= {s for s, _ in losses}, (evals, losses)
    first = [v for s, v in losses if s <= evals[0]]
    last = [v for s, v in losses if s > evals[-2]]
    first_mean, last_mean = statistics.mean(first), statistics.mean(last)
    assert last_mean < first_mean, (first_mean, last_mean, losses)
    auc = ", ".join(f"{c['step']}: {c['val_epoch_AUC']:.4f}" for c in record["val_auc_curve"])
    log(f"[sustained] sustained_train.run, depth {CUT_DEPTH}, bf16, b{TRAIN_BATCH}, "
        f"{SUSTAINED_K}-step CUDA graphs, {record['events']} twin events: {steps} steps + "
        f"{len(evals)} validations ({val_batches} batches) in {record['wall_s']:.2f} s; "
        f"mean train_loss {first_mean:.5f} over steps 1-{evals[0]}, {last_mean:.5f} over "
        f"{evals[-2] + 1}-{steps}; val_epoch_AUC {auc}; K1 {counts[0]} (of them "
        f"{record['k1_warmup_launches']} in the warm-ups), K2 {counts[1]}")
    rates = [round(w["events_per_second"], 2) for w in record["window_events_per_second"]]
    log(f"[sustained] logged events/s windows {rates}, steady state "
        f"{record['steady_state_events_per_second']:.2f}; peak memory "
        f"{record['peak_memory_gib']:.2f} GiB ({smi}; beside phase 13's compiles)")
    return counts[0]


# ---------------------------------------------------------------------------
# phase 18
# ---------------------------------------------------------------------------

def parallel_trainer(ranks, mp, device, sync_bn):
    """The option file's whole network, bf16, ``TRAIN_BATCH`` a data shard
    over ``ranks`` ranks of ``mp`` a row, static shapes, sync-BN as asked:
    a graph Trainer (the graph-safe AdamW) and its first ``PAR_STEPS``
    batches (this rank's shards) on the card."""
    options = Options.load(OPTION_FILE)
    options.compute_dtype = "bfloat16"
    options.batch_size = TRAIN_BATCH
    options.num_gpu, options.model_parallel = ranks, mp
    options.sync_batch_norm = sync_bn
    options.static_batch_shapes = True      # a world of one takes a group's shapes
    dp = ranks // mp
    trainer = Trainer(options, debug=True, device=device, verbose=False, graph=True,
                      datasets=(InMemoryEvents(dp * TRAIN_BATCH * PAR_STEPS, SEED + 80),
                                InMemoryEvents(DP_VAL_EVENTS, SEED + 81), None))
    assert (trainer.mesh.dp, trainer.mesh.mp) == (dp, mp), trainer.mesh
    batches = [to_device(b, device) for b in
               itertools.islice(trainer.train_batcher.epoch(0), PAR_STEPS)]
    return trainer, batches


def flat_state(host):
    """A host ``TrainState.state_dict()``'s tensors by name."""
    out = {f"model.{n}": t for n, t in host["model"].items()}
    for i, slots in host["optimizer"]["state"].items():
        out.update({f"adamw.{i}.{k}": t for k, t in slots.items() if torch.is_tensor(t)})
    return out


def meet(device):
    """The ranks in step (no-op without a group): one all-reduce, waited for."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.all_reduce(torch.zeros(1, device=device))
    torch.cuda.synchronize(device)


def parallel_run(ranks, mp, device, k, graph, sync_bn):
    """``PAR_STEPS`` train steps from the option file's seeded start:
    eager, or replays of a ``k``-step graph.  Returns the whole state on
    the host, the stacked metrics and the readings."""
    free_memory()
    trainer, batches = parallel_trainer(ranks, mp, device, sync_bn)
    model, options, mesh = trainer.state.model, trainer.options, trainer.mesh
    if graph:
        step = make_train_step(model, options, mesh, graph=True, steps_per_dispatch=k)
        calls = stack_groups(batches, k) if k > 1 else batches
    else:
        step = make_train_step(model, options, mesh)
        calls = batches
    untimed = len(calls) - PAR_TIMED // k
    torch.cuda.reset_peak_memory_stats(device)

    def run():
        out, first_s = [], None
        for i, call in enumerate(calls):
            if i == untimed:
                meet(device)
                t0 = time.perf_counter()
            t = time.perf_counter()
            out.append(step(trainer.state, call))
            if i == 0:
                torch.cuda.synchronize(device)
                first_s = time.perf_counter() - t
        host_s = time.perf_counter() - t0
        torch.cuda.synchronize(device)
        return out, first_s, host_s, time.perf_counter() - t0

    (metrics, first_s, host_s, seconds), counts = counted(run)
    forwards = PAR_STEPS + (k if graph else 0)        # a capture's warm-up steps
    assert counts == (2 * forwards, 0), (counts, forwards)
    if graph:
        for captured in step.graphs.graphs.values():
            assert captured.launches == [2 * k, 0], captured.launches
        metrics = {n: torch.cat([m[n].reshape(-1) for m in metrics]).cpu() for n in metrics[0]}
    else:
        metrics = {n: torch.stack([m[n].float() for m in metrics]).cpu() for n in metrics[0]}
    reading = dict(ms_per_step=1e3 * seconds / PAR_TIMED, host_ms=1e3 * host_s / PAR_TIMED,
                   first_s=first_s, k1=counts[0],
                   peak_gib=torch.cuda.max_memory_allocated(device) / 2 ** 30,
                   reserved_gib=torch.cuda.memory_reserved(device) / 2 ** 30,
                   losses=metrics["train_loss"].tolist())
    host = to_host(trainer.state.state_dict())     # a sharded state gathered whole
    assert trainer.state.step == PAR_STEPS and all(
        torch.isfinite(v).all() for v in metrics.values()), metrics
    del trainer, model, step, calls, batches
    free_memory()
    return host, metrics, reading


def graph_parallel_rank(rank, ranks, backend, rendezvous, mp, layout, out_path):
    """One rank of phase 18 (a process of its own; ``ranks`` 1 joins no
    group): the layout's runs (``PAR_RUNS``) from the same start, each
    graph run's state and metrics against the eager run's, and the
    readings, written to ``out_path``."""
    import torch.distributed as dist

    mp = int(mp)
    if ranks > 1:
        device = join_tp_group(rank, ranks, backend, rendezvous)
    else:
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    out = dict(rank=rank, device=str(device), runs={}, against_eager={})
    try:
        eager = None
        for name, k, graph, sync_bn in PAR_RUNS[layout]:
            host, metrics, reading = parallel_run(ranks, mp, device, k, graph, sync_bn)
            reading["digest"] = host_digest(host)
            out["runs"][name] = reading
            if name == "eager":
                eager = {**flat_state(host), **{f"metric.{n}": v for n, v in metrics.items()}}
            elif sync_bn:
                got = {**flat_state(host), **{f"metric.{n}": v for n, v in metrics.items()}}
                exact = all(torch.equal(got[n], eager[n]) for n in eager)
                gap, where = (0.0, None) if exact else relative_gap(got, eager)
                out["against_eager"][name] = dict(exact=exact, gap=gap, where=where)
        # the cause, where a graph run is not eager's on some rank: two
        # eager runs against each other (every rank runs them, together)
        differs = torch.tensor([float(not all(r["exact"] for r in
                                              out["against_eager"].values()))], device=device)
        if ranks > 1:
            dist.all_reduce(differs, op=dist.ReduceOp.MAX)
        if float(differs):
            runs = [flat_state(parallel_run(ranks, mp, device, 1, False, True)[0])
                    for _ in range(2)]
            out["eager_gap"] = relative_gap(*runs)
    finally:
        if ranks > 1:
            dist.destroy_process_group()
    with open(out_path, "w") as f:
        json.dump(out, f)


def check_graph_parallel(smi, ranks=None):
    """Phase 18's multi-card part: on 4 cards dp4 and dp2 x mp2, on 2 dp2
    and dp1 x mp2, one process a card over nccl, beside a world of one in
    its own process first; each layout's graph runs (4-step and one-step
    graphs, and the 4-step graph with sync-BN off) against its eager run
    from the same start, bit for bit (or within 2^-7 with the cause
    printed), the ranks' whole states equal, K1 from the replays; ms/step,
    events/s over the ranks and peak memory per rank.  Returns K1's
    launches over every rank; on one card logs that it needs 2 or 4 and
    returns 0."""
    cards = torch.cuda.device_count()
    ranks = ranks or (4 if cards >= 4 else 2 if cards >= 2 else 1)
    if ranks < 2 or cards < ranks:
        log(f"[graph-dp] the data- and tensor-parallel graph steps need 2 or 4 cards, one a "
            f"rank over nccl; this machine has {cards}: not run here "
            "(chip_smoke.check_graph_parallel on a machine with 4)")
        return 0
    layouts = [("one", 1, 1), ("dp", ranks, 1), ("tp", ranks, TP_MP)]
    work = tempfile.mkdtemp(prefix="chip_smoke_graph_dp_")
    launches = 0
    try:
        results = {}
        for layout, n, mp in layouts:
            where = os.path.join(work, layout)
            os.makedirs(where)
            t0 = time.perf_counter()
            results[layout] = finish_tp_ranks(*start_tp_ranks(
                "graph_parallel_rank", n, "nccl", where, mp, layout), PAR_TIMEOUT_S)
            log(f"[graph-dp] {layout}: {n} process(es) done in "
                f"{time.perf_counter() - t0:.1f} s")
        one = results["one"][0]["runs"]
        for layout, n, mp in layouts:
            dp = n // mp
            shape = "world of one" if layout == "one" else f"dp{dp} x mp{mp}"
            for r in results[layout]:
                launches += sum(run["k1"] for run in r["runs"].values())
                for name, run in r["runs"].items():
                    base = one.get(name)
                    beside = (f"; world of one {base['ms_per_step']:.2f} ms/step, peak "
                              f"{base['peak_gib']:.2f} GiB" if base and layout != "one"
                              else "")
                    log(f"[graph-dp] {shape} ({'nccl' if n > 1 else 'no group'}), full depth, "
                        f"bf16, b{TRAIN_BATCH} a data shard, rank {r['rank']} on "
                        f"{r['device']}, {name}: {run['ms_per_step']:.2f} ms/step over the last "
                        f"{PAR_TIMED} of {PAR_STEPS} steps (host "
                        f"{run['host_ms']:.2f}), {dp * TRAIN_BATCH / run['ms_per_step'] * 1e3:.2f} "
                        f"events/s over the ranks; first call {run['first_s']:.2f} s; peak "
                        f"{run['peak_gib']:.2f} GiB, reserved {run['reserved_gib']:.2f}; K1 "
                        f"{run['k1']}{beside} ({smi})")
            for name in results[layout][0]["against_eager"]:
                verdicts = [r["against_eager"][name] for r in results[layout]]
                digests = {r["runs"][name]["digest"] for r in results[layout]}
                assert len(digests) == 1, f"{shape} {name}: the ranks' whole states differ"
                if all(v["exact"] for v in verdicts):
                    agreement = "bit for bit"
                else:
                    cause = results[layout][0].get("eager_gap")
                    worst = max(verdicts, key=lambda v: v["gap"])
                    agreement = (f"not bit for bit: largest relative gap {worst['gap']:.3g} "
                                 f"({worst['where']}); two eager runs differ by "
                                 f"{cause[0]:.3g} ({cause[1]})")
                    assert worst["gap"] <= GRAPH_TOL, (shape, name, worst, cause)
                losses = results[layout][0]["runs"][name]["losses"]
                log(f"[graph-dp] {shape}, full depth: {name} against {PAR_STEPS} eager steps "
                    f"from the "
                    f"same start (dropout and noise on), every rank: metrics, whole "
                    f"parameters, running statistics and AdamW's moments {agreement}; the "
                    f"ranks' whole states equal; train_loss {losses[0]:.5f} -> "
                    f"{losses[-1]:.5f}")
        return launches
    finally:
        shutil.rmtree(work, ignore_errors=True)


def side_child(smi, out_path):
    """Phases 10, 17 (but its compiled step) and 19, one after the other,
    in a process of its own (``Side``), with phase 1's TF32 switch: logs to
    its output, writes their K1 and K2 launches to ``out_path``."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    k1 = check_families(smi)
    log(f"[time] phase 10 took {time.perf_counter() - t0:.1f} s in the side process")
    free_memory()
    t0 = time.perf_counter()
    recipes_k1, k2 = check_recipes(smi, compiled=False)
    k1 += recipes_k1
    log(f"[time] phase 17 (but its compiled step) took {time.perf_counter() - t0:.1f} s "
        "in the side process")
    free_memory()
    t0 = time.perf_counter()
    k1 += check_sustained(smi)
    log(f"[time] phase 19 took {time.perf_counter() - t0:.1f} s in the side process")
    with open(out_path, "w") as f:
        json.dump({"k1": k1, "k2": k2}, f)


class Side:
    """``side_child`` started: phases 10, 17 (but its compiled step) and
    19 run on the card while phase 13 compiles on the host.  ``wait()`` waits for
    the process (once), logs its lines and returns its K1 and K2 launches,
    or raises with its output if it failed."""

    def __init__(self, work, smi):
        here = os.path.dirname(os.path.abspath(__file__))
        self.out, self.log_path = os.path.join(work, "side.json"), os.path.join(work, "side.log")
        self.launches = None
        with open(self.log_path, "w") as f:
            self.proc = subprocess.Popen(
                [sys.executable, "-c",
                 f"import chip_smoke; chip_smoke.side_child({smi!r}, {self.out!r})"],
                cwd=here, stdout=f, stderr=subprocess.STDOUT)

    def wait(self):
        if self.launches is None:
            try:
                self.proc.wait(timeout=SIDE_TIMEOUT_S)
            finally:
                stop([self.proc])
            with open(self.log_path) as f:
                text = f.read()
            if self.proc.returncode != 0:
                raise RuntimeError(f"phases 10, 17 and 19 exited {self.proc.returncode}:\n"
                                   f"{text[-8000:]}")
            for line in text.splitlines():
                if line.startswith("["):
                    log(line)
            with open(self.out) as f:
                launches = json.load(f)
            self.launches = launches["k1"], launches["k2"]
        return self.launches


@contextlib.contextmanager
def timing_after(wait):
    """Inside it, the AOTInductor packaging's bucket timing
    (``aoti._time_bucket_ms``) calls ``wait()`` first, so that it times a
    package on a card no other process of the smoke is timing work on."""
    from dune_transformercvn_torch import aoti

    timer = aoti._time_bucket_ms

    def timed(*args, **kwargs):
        wait()
        return timer(*args, **kwargs)

    aoti._time_bucket_ms = timed
    try:
        yield
    finally:
        aoti._time_bucket_ms = timer


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; this smoke "
                 "test needs an NVIDIA GPU")

    def done(phases):
        log(f"[time] phases {phases} done at {time.perf_counter() - STARTED:.1f} s")

    smi = device_and_build()
    work = tempfile.mkdtemp(prefix="chip_smoke_work_")
    procs = []
    try:
        # the slowest graphs of phases 15 and 17 compile beside phases 1-12
        early = start_warming(work, EARLY_GRAPHS, nice=10)
        procs += early[0].values()
        k1 = check_k1()
        dense_model, dense_counts = check_serving("dense")
        conv0 = dense_model.prong_embedding.event_pixel_embedding.features.conv0
        k2 = check_k2(conv0.weight.detach().float(), conv0.bias.detach().float())
        _, coo_counts = check_serving("coo")
        train_launches = check_training()
        check_paths(dense_model)
        del dense_model, conv0
        gc.collect()
        torch.cuda.empty_cache()
        done("1-7")
        trainer_launches = check_trainer(smi)
        remat_readings(smi)
        gc.collect()
        torch.cuda.empty_cache()
        done("8")
        trainer_launches += check_data_parallel(smi)
        check_world_of_one()
        done("9")
        launches, served = check_serving_variants(smi, work)
        trainer_launches += launches
        done("11")
        trainer_launches += check_remaining_modules(smi)
        done("12")
        # phase 14's compiled TP ranks and the other graphs compile at a
        # low priority beside phase 13, and phases 10, 17 and 19 run on
        # the card while phase 13 compiles; phase 13 times its packages once
        # they are done, and the TP ranks are timed once every graph is in
        # the cache
        compiled_tp = start_compiled_tp(work)
        procs += compiled_tp[1][0]
        late = start_warming(work, tuple(n for n in WARM_GRAPHS if n not in EARLY_GRAPHS),
                             nice=10)
        procs += late[0].values()
        side = Side(work, smi)
        procs.append(side.proc)
        check_aoti_serving(smi, served, work, card_free=side.wait)
        del served
        free_memory()
        done("13")
        side_k1, side_k2 = side.wait()
        trainer_launches += side_k1
        train_launches += side_k2
        done("10, 17 (but its compiled step) and 19, beside 13,")
        finish_warming(early, smi, beside=" (started before phase 2, at nice 10)")
        finish_warming(late, smi, beside=" (started with phase 13, at nice 10)")
        trainer_launches += finish_compiled_tp(compiled_tp, smi)
    finally:
        stop(procs)
        shutil.rmtree(work, ignore_errors=True)
    trainer_launches += check_tensor_parallel(smi)
    done("14")
    compiled_k1, compiled_k2 = check_compiled(smi, warmed=True)
    trainer_launches += compiled_k1
    train_launches += compiled_k2
    done("15")
    # phase 17's compiled step, from the cache; before phase 16, whose
    # profiler reading stays last
    with bench_precision():
        trainer_launches += compiled_remat(smi)
    done("17's compiled step")
    graph_k1, graph_k2 = check_graphs(smi)
    trainer_launches += graph_k1
    train_launches += graph_k2
    done("16")
    trainer_launches += check_world_of_one(graph=True)
    trainer_launches += check_graph_parallel(smi)
    done("18")
    kernels = []
    for (err, ms, plain_ms, lib_ms, bound_ms), name, source, replaces, launches in (
            (k1, "densify", "dune_transformercvn_torch/csrc/densify.cu",
             "dune_transformercvn_tpu/ops/pallas_densify.py:61",
             int(dense_counts[0]) + trainer_launches),
            (k2, "coo_stem_scatter", "dune_transformercvn_torch/csrc/coo_stem.cu",
             "dune_transformercvn_tpu/ops/pallas_coo_stem.py:146",
             int(coo_counts[1]) + train_launches)):
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": lib_ms,
        })
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
