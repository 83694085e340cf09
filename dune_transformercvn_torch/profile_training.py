"""Where the training step's time goes on one GPU.

    python -m dune_transformercvn_torch.profile_training [--out FILE]

For the coo and the dense family, with the production option file at full
width in bfloat16 (its AdamW, schedule, clip, dropout and pixel noise),
random weights from seed 0 and batches of 16 events made in memory
(:class:`.data.InMemoryEvents`):

1. 3 warm-up steps, then 10 train steps back to back (the host waits for
   the device only at the end): wall ms per step, events/s, peak memory.
   Both families are timed before either is profiled.
2. ``torch.profiler`` over 3 more steps: kernel time by kind, kernel
   launches per step, the host's time in the step's forward, backward and
   optimizer ranges, and the device's busy share between the first
   kernel's start and the last kernel's end.

Prints every result, and with ``--out`` writes them all as one JSON object.
Needs a CUDA device; builds the port's kernels on first use.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import torch

from . import Options
from .data import Batcher, InMemoryEvents
from .models import TransformerCVN
from .predict import to_device
from .profile_serving import OPTION_FILE, _kind, _union_us, production_config
from .train import create_train_state, make_train_step

BATCH, WARMUP, TIMED, PROFILED, SEED = 16, 3, 10, 3, 0
RANGES = ("train_step.forward", "train_step.backward", "train_step.optimizer")


def setup(embedder):
    options = Options.load(OPTION_FILE)
    cfg = dataclasses.replace(production_config("bfloat16"), embedder=embedder)
    steps = WARMUP + TIMED + PROFILED
    ds = InMemoryEvents(BATCH * steps, SEED + 3)
    batcher = Batcher(ds, batch_size=BATCH, shuffle=True, seed=SEED)
    batches = [to_device(b, "cuda") for b in batcher.epoch(0)]
    model = TransformerCVN(cfg, generator=torch.Generator().manual_seed(SEED)).to("cuda")
    state = create_train_state(model, options, ds.norm(), len(batcher), seed=SEED)
    return state, make_train_step(model, options), batches


def timed(state, step, batches):
    """Wall ms per step over back-to-back steps, after the warm-up."""
    for b in batches[:WARMUP]:
        step(state, b)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for b in batches[WARMUP:WARMUP + TIMED]:
        metrics = step(state, b)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / TIMED
    return {"ms_per_step": ms, "events_per_s": 1e3 * BATCH / ms,
            "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "last_loss": float(metrics["train_loss"]),
            "last_grad_norm": float(metrics["grad_norm"])}


def profiled(state, step, batches):
    """Kernel time by kind, launches, host ranges and busy share."""
    from torch.profiler import ProfilerActivity, profile

    batches = batches[WARMUP + TIMED:]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for b in batches:
            step(state, b)
        torch.cuda.synchronize()
    events = list(prof.events())
    # device events that are kernels: not the ranges' and the optimizer's
    # own annotations, which the profiler mirrors on the device timeline
    kernels = [(e.name, e.time_range.start, e.time_range.end) for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.name.startswith(RANGES + ("Optimizer.",))]
    n = len(batches)
    host = {r: sum(e.time_range.end - e.time_range.start for e in events
                   if e.name == r and e.device_type == torch.autograd.DeviceType.CPU)
            / 1e3 / n for r in RANGES}
    if not kernels:
        return {"device_events": 0, "host_ms_per_step": host}
    by_kind, top = {}, {}
    for name, s, e in kernels:
        kind = _kind(name)
        by_kind[kind] = by_kind.get(kind, 0.0) + (e - s)
        top[name] = top.get(name, 0.0) + (e - s)
    kernel_us = sum(by_kind.values())
    window_us = max(e for _, _, e in kernels) - min(s for _, s, _ in kernels)
    return {
        "device_events": len(kernels),
        "launches_per_step": len(kernels) / n,
        "kernel_ms_per_step": kernel_us / 1e3 / n,
        "window_ms_per_step": window_us / 1e3 / n,
        "busy_share": _union_us([(s, e) for _, s, e in kernels]) / window_us,
        "host_ms_per_step": host,
        "share_by_kind": {k: v / kernel_us for k, v in
                          sorted(by_kind.items(), key=lambda kv: -kv[1])},
        "top_kernels_ms_per_step": {
            k[:120]: v / 1e3 / n for k, v in
            sorted(top.items(), key=lambda kv: -kv[1])[:12]},
    }


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default=None, help="write the results here as JSON")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_training needs a CUDA device")
    results = {"device": torch.cuda.get_device_name(0), "torch": torch.__version__,
               "batch_size": BATCH, "families": {}}
    runs = {embedder: setup(embedder) for embedder in ("coo", "dense")}
    # every family is timed before the first profiler session: a session
    # slows the host-bound work after it in the same process
    for embedder, run in runs.items():
        r = results["families"][embedder] = {"timed": timed(*run)}
        print(f"[{embedder}] {json.dumps(r['timed'])}", flush=True)
    for embedder, run in runs.items():
        r = results["families"][embedder]
        r["profile"] = profiled(*run)
        print(f"[{embedder}] profile: {json.dumps(r['profile'])}", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
