#!/usr/bin/env python3
"""Readings of the memory recipes on one NVIDIA GPU that ``chip_smoke.py``
does not take (each costs minutes of the card, or may not fit on it).

    python3 recipes_probe.py eager_remat [--root DIR]
    python3 recipes_probe.py b64
    python3 recipes_probe.py sdxl_compile

* ``eager_remat``: the option file's dense network whole, bf16, b16, the
  eager train step plain, with ``remat_cnn`` and with ``remat_embedder``:
  ms/step and peak memory (``EAGER_STEPS`` steps after ``EAGER_WARMUP``).
  ``--root`` runs the port and ``chip_smoke.py`` of another checkout (an
  older commit unpacked with ``git archive``), whose kernels it builds
  there, so that two commits compare on one card: run them in turns
  (A, B, B, A) on one card.
* ``b64``: that network with ``remat_cnn`` at b64, static shapes, as the
  one-step CUDA graph, in a child process: whether its warm-up and capture
  fit on the card, and its ms/step over ``B64_REPLAYS`` replays if so.
* ``sdxl_compile``: the sdxl b16 train step with ``embedder_chunk`` 16 at
  full width, bf16, static shapes, compiled (Inductor, its chunk region
  traced once) against eager: the first call's seconds (the cold
  compile), ms/step and peak memory.  Its cold compile did not end within
  23 minutes on the H100 host: give it a long time limit.

Each prints its reading with the card's name and power limit.  Needs one
CUDA device."""
from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import torch

EAGER_WARMUP, EAGER_STEPS = 2, 5
B64_BATCH, B64_REPLAYS, B64_TIMEOUT_S = 64, 3, 300


def smoke(root=None):
    """``chip_smoke`` of the checkout at ``root`` (default: this one), with
    that checkout's port first on the path."""
    root = os.path.abspath(root or os.path.dirname(os.path.abspath(__file__)))
    os.chdir(root)
    sys.path.insert(0, root)
    return importlib.import_module("chip_smoke")


def eager_remat(s, smi):
    options = s.Options.load(s.OPTION_FILE)
    options.compute_dtype = "bfloat16"
    ds = s.InMemoryEvents(s.TRAIN_BATCH * (EAGER_WARMUP + EAGER_STEPS), s.SEED + 7)
    batches = [s.to_device(b, "cuda") for b in s.Batcher(ds, batch_size=s.TRAIN_BATCH).epoch(0)]
    readings = []
    for flags in ({}, {"remat_cnn": True}, {"remat_embedder": True}):
        cfg = dataclasses.replace(s.production_config("bfloat16"), **flags)
        model = s.TransformerCVN(cfg, generator=torch.Generator().manual_seed(s.SEED)).cuda()
        state = s.create_train_state(model, options, ds.norm(), len(batches), seed=s.SEED)
        step = s.make_train_step(model, options)
        for batch in batches[:EAGER_WARMUP]:
            step(state, batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for batch in batches[EAGER_WARMUP:]:
            metrics = step(state, batch)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / EAGER_STEPS
        assert math.isfinite(float(metrics["train_loss"])), metrics
        readings.append(f"{'+'.join(flags) or 'plain'} {ms:.2f} ms/step, peak "
                        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
        del model, state, step, metrics
        gc.collect()
        torch.cuda.empty_cache()
    s.log(f"[probe] eager dense b16 train step, full depth, bf16 ({s.__file__}): "
          + "; ".join(readings) + f" ({EAGER_STEPS} steps after {EAGER_WARMUP}; {smi})")


def remat_b64_graph(out_path):
    """In a process of its own (``b64``): the one-step graph of the dense
    network with ``remat_cnn`` at b64; writes a JSON record."""
    s = smoke()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    options = s.Options.load(s.OPTION_FILE)
    cfg = dataclasses.replace(s.production_config("bfloat16"), remat_cnn=True)
    ds, batches = s.graph_train_batches(cfg, s.SEED + 110, B64_REPLAYS + 1, B64_BATCH)
    model = s.TransformerCVN(cfg, generator=torch.Generator().manual_seed(s.SEED)).cuda()
    state = s.create_train_state(model, options, ds.norm(), 100, seed=s.SEED, graph=True)
    step = s.make_train_step(model, options, graph=True)
    record = {"batch": B64_BATCH, "prong_slots": int(batches[0]["slot_batch"].shape[0])}
    torch.cuda.reset_peak_memory_stats()
    try:
        _, first = s.counted(lambda: step(state, batches[0]))
    except (torch.cuda.OutOfMemoryError, RuntimeError) as error:
        if "out of memory" not in str(error):
            raise
        record.update(fits=False, error=str(error).splitlines()[0][:300],
                      peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    else:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics, counts = s.counted(lambda: [step(state, b) for b in batches[1:]][-1])
        ms = 1e3 * (time.perf_counter() - t0) / B64_REPLAYS
        assert first == (4, 0) and counts == (2 * B64_REPLAYS, 0), (first, counts)
        assert math.isfinite(float(metrics["train_loss"])), metrics
        record.update(fits=True, ms_per_step=ms,
                      peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                      reserved_gib=torch.cuda.memory_reserved() / 2 ** 30)
    with open(out_path, "w") as f:
        json.dump(record, f)


def remat_b64(s, smi):
    with tempfile.TemporaryDirectory(prefix="recipes_probe_b64_") as work:
        out = os.path.join(work, "b64.json")
        proc = subprocess.run(
            [sys.executable, "-c", f"import recipes_probe; recipes_probe.remat_b64_graph({out!r})"],
            cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True, text=True,
            timeout=B64_TIMEOUT_S)
        if proc.returncode != 0:
            raise RuntimeError(f"the b64 remat graph exited {proc.returncode}:\n"
                               f"{proc.stdout[-3000:]}\n{proc.stderr[-6000:]}")
        with open(out) as f:
            record = json.load(f)
    if record["fits"]:
        reading = (f"fits: {record['ms_per_step']:.2f} ms/step over {B64_REPLAYS} replays, "
                   f"peak {record['peak_gib']:.2f} GiB allocated, "
                   f"{record['reserved_gib']:.2f} GiB reserved")
    else:
        reading = (f"does not fit: out of memory at {record['peak_gib']:.2f} GiB allocated "
                   f"({record['error']})")
    s.log(f"[probe] dense train step with remat_cnn, full depth, bf16, b{B64_BATCH}, static "
          f"shapes ({record['prong_slots']} prong slots), the one-step graph: {reading} ({smi})")


def sdxl_compile(s, smi):
    steps = s.SDXL_GRAPH_STEPS
    options = s.Options.load(s.OPTION_FILE)
    cfg = s.family_config("sdxl", embedder_chunk=s.SDXL_GRAPH_CHUNK)
    ds, batches = s.graph_train_batches(cfg, s.SEED + 100, steps + 1)
    readings = []
    for compile in (False, True):
        model = s.TransformerCVN(cfg, generator=torch.Generator().manual_seed(s.SEED)).cuda()
        state = s.create_train_state(model, options, ds.norm(), 100, seed=s.SEED)
        step = s.make_train_step(model, options, compile=compile)
        t0 = time.perf_counter()
        _, first = s.counted(lambda: step(state, batches[0]))
        first_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        metrics, counts = s.counted(lambda: [step(state, b) for b in batches[1:]][-1])
        ms = 1e3 * (time.perf_counter() - t0) / steps
        assert (first, counts) == ((2, 0), (2 * steps, 0)), (first, counts)
        assert math.isfinite(float(metrics["train_loss"])), metrics
        readings.append(f"{'compiled' if compile else 'eager'}: first call {first_s:.1f} s, "
                        f"{ms:.2f} ms/step, peak "
                        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
        del model, state, step
        s.free_memory()
    s.log(f"[probe] sdxl train step, chunk {s.SDXL_GRAPH_CHUNK}, full width, bf16, "
          f"b{s.TRAIN_BATCH}, static shapes, over {steps} steps after the first: "
          + "; ".join(readings) + f" ({smi})")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("reading", choices=["eager_remat", "b64", "sdxl_compile"])
    p.add_argument("--root", default=None,
                   help="eager_remat: the checkout whose port and chip_smoke.py to run")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("recipes_probe: torch.cuda.is_available() is False; it needs an NVIDIA GPU")
    if args.root is not None and args.reading != "eager_remat":
        p.error("--root is for eager_remat")
    s = smoke(args.root)
    smi = s.device_and_build()
    {"eager_remat": eager_remat, "b64": remat_b64, "sdxl_compile": sdxl_compile}[
        args.reading](s, smi)


if __name__ == "__main__":
    main()
