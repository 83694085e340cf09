"""Where the serving path's time goes on one GPU.

    python -m dune_transformercvn_torch.profile_serving [--out FILE]

At batch 16 and at batch 64, over 1,024 events made in memory
(:class:`.data.InMemoryEvents`) with the production dense configuration in
bfloat16 and random weights from seed 0:

1. ``predict_split`` end to end after one warm-up pass over the same events:
   ms per batch and events/s, median and range over 3 passes.
2. The same loop timed stage by stage: waiting for the next batch, the
   host-to-device copy, dispatching the forward (kernels queued), waiting for
   the device and copying the probabilities back, host bookkeeping.  Once
   with the batcher's prefetch thread (as ``predict_split`` runs) and once
   with each batch built inline.
3. Forwards back to back on batches already on the card, with no
   synchronisation between them: wall ms per batch.
4. ``torch.profiler`` over 4 such forwards: kernel time by kind,
   kernel launches per forward, and the device's busy share between the
   first kernel's start and the last kernel's end.

Prints every result, and with ``--out`` writes them all as one JSON object.
Needs a CUDA device; builds the port's kernels on first use.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import time

import numpy as np
import torch

from . import Options
from .data import Batcher, InMemoryEvents
from .models import ModelConfig, TransformerCVN
from .predict import make_predict_step, predict_split, to_device

OPTION_FILE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "option_files", "fdhd_beam_2018prod_2023_08_07.json")
IMAGE_SHAPE, CHANNELS = (400, 280), 3
COO_GRANULARITY = 8192            # predict_split's default
STAGES = ("next_batch", "h2d", "dispatch", "wait_d2h", "post")
BATCH_SIZES, EVENTS, PASSES, PROFILED, SEED = (16, 64), 1024, 3, 4, 0

# kernel kinds, matched in this order against the lower-cased kernel name
KINDS = (
    ("densify (K1)", ("densify",)),
    ("coo stem scatter (K2)", ("coo_stem",)),
    ("pooling", ("pool",)),
    ("softmax / attention", ("softmax", "attention", "fmha", "flash")),
    ("group norm", ("groupnorm", "group_norm", "rowwisemoments", "computefusedparams",
                    "computeinternalgradients", "gammabeta")),
    ("layout transpose", ("nchwtonhwc", "nhwctonchw")),
    ("convolution", ("conv", "fprop", "implicit", "xmma", "winograd", "nhwc", "nchw")),
    ("gemm", ("gemm", "cublas", "cutlass", "matmul")),
    ("reduction", ("reduce",)),
    ("elementwise", ("elementwise", "unrolled", "vectorized")),
    ("memcpy / memset", ("memcpy", "memset")),
)


def production_config(compute_dtype: str = "bfloat16") -> ModelConfig:
    """The production dense option file at full width."""
    cfg = ModelConfig.from_options(
        Options.load(OPTION_FILE), features_dim=6, extra_dim=4,
        pixel_channels=CHANNELS, num_event_classes=4, num_prong_classes=8,
        image_shape=IMAGE_SHAPE)
    return dataclasses.replace(cfg, compute_dtype=compute_dtype)


def _batcher(ds, batch_size):
    return Batcher(ds, batch_size=batch_size, coo_granularity=COO_GRANULARITY,
                   drop_last=False)


def end_to_end(model, ds, batch_size, passes):
    """``predict_split`` wall time per batch, after a warm-up pass."""
    num_batches = -(-len(ds) // batch_size)
    predict_split(model, ds, ds.norm(), batch_size, "cuda")
    ms = []
    for _ in range(passes):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        predict_split(model, ds, ds.norm(), batch_size, "cuda")
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0) / num_batches)
    return {"ms_per_batch": ms,
            "events_per_s": [1e3 * batch_size / m for m in ms]}


def staged(model, ds, batch_size, prefetch):
    """``predict_split``'s loop with a clock read between its stages; mean
    ms per batch of each stage and of the whole pass."""
    batcher = _batcher(ds, batch_size)
    step = make_predict_step(model)
    norm = to_device(ds.norm(), "cuda")
    batches = iter(batcher.prefetch_epoch(0) if prefetch else batcher.epoch(0))
    stages = dict.fromkeys(STAGES, 0.0)
    count = 0
    torch.cuda.synchronize()
    start = clock = time.perf_counter()

    def lap(stage):
        nonlocal clock
        now = time.perf_counter()
        stages[stage] += now - clock
        clock = now

    while True:
        batch = next(batches, None)
        lap("next_batch")
        if batch is None:
            break
        device_batch = to_device(batch, "cuda")
        lap("h2d")
        probs_e, probs_p = step(device_batch, norm)
        lap("dispatch")
        probs_e, probs_p = probs_e.cpu().numpy(), probs_p.cpu().numpy()
        lap("wait_d2h")
        mask = batch["prong_targets"] >= 0
        np.concatenate([probs_p[mask].ravel(), probs_e.ravel()])
        lap("post")
        count += 1
    total = time.perf_counter() - start
    out = {k: 1e3 * v / count for k, v in stages.items()}
    out["total"] = 1e3 * total / count
    return out


def back_to_back(model, ds, batches, repeats=2):
    """Wall ms per forward with the host never waiting for the device."""
    step = make_predict_step(model)
    norm = to_device(ds.norm(), "cuda")
    for b in batches:
        step(b, norm)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(repeats):
        for b in batches:
            step(b, norm)
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / (repeats * len(batches))


def _kind(name: str) -> str:
    low = name.lower()
    for kind, keys in KINDS:
        if any(k in low for k in keys):
            return kind
    return "other"


def _union_us(intervals):
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def profiled(model, ds, batches, num_forwards):
    """Kernel time by kind and device busy share over back-to-back forwards."""
    from torch.profiler import ProfilerActivity, profile

    step = make_predict_step(model)
    norm = to_device(ds.norm(), "cuda")
    batches = batches[:num_forwards]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for b in batches:
            step(b, norm)
        torch.cuda.synchronize()
    kernels = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        return {"device_events": 0}   # the profiler saw no device activity
    by_kind, top = {}, {}
    for name, s, e in kernels:
        kind = _kind(name)
        by_kind[kind] = by_kind.get(kind, 0.0) + (e - s)
        top[name] = top.get(name, 0.0) + (e - s)
    kernel_us = sum(by_kind.values())
    window_us = max(e for _, _, e in kernels) - min(s for _, s, _ in kernels)
    n = len(batches)
    return {
        "device_events": len(kernels),
        "launches_per_forward": len(kernels) / n,
        "kernel_ms_per_forward": kernel_us / 1e3 / n,
        "window_ms_per_forward": window_us / 1e3 / n,
        "busy_share": _union_us([(s, e) for _, s, e in kernels]) / window_us,
        "share_by_kind": {k: v / kernel_us for k, v in
                          sorted(by_kind.items(), key=lambda kv: -kv[1])},
        "top_kernels_ms_per_forward": {
            k[:120]: v / 1e3 / n for k, v in
            sorted(top.items(), key=lambda kv: -kv[1])[:12]},
    }


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default=None, help="write the results here as JSON")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_serving needs a CUDA device")

    cfg = production_config("bfloat16")
    model = TransformerCVN(cfg, generator=torch.Generator().manual_seed(SEED))
    model = model.to("cuda").eval()
    results = {"device": torch.cuda.get_device_name(0), "torch": torch.__version__,
               "events": EVENTS, "batch_sizes": {}}
    for batch_size in BATCH_SIZES:
        ds = InMemoryEvents(EVENTS, SEED + batch_size)
        r = {"end_to_end": end_to_end(model, ds, batch_size, PASSES),
             "staged_prefetch": staged(model, ds, batch_size, prefetch=True),
             "staged_inline": staged(model, ds, batch_size, prefetch=False)}
        batches = [to_device(b, "cuda") for b in _batcher(ds, batch_size).epoch(0)]
        r["prong_slots"] = sorted({int(b["slot_batch"].shape[0]) for b in batches})
        r["back_to_back_ms_per_batch"] = back_to_back(model, ds, batches)
        r["profile"] = profiled(model, ds, batches, PROFILED)
        results["batch_sizes"][batch_size] = r
        e2e = r["end_to_end"]
        print(f"[b{batch_size}] predict_split: median "
              f"{statistics.median(e2e['ms_per_batch']):.3f} ms/batch, "
              f"{statistics.median(e2e['events_per_s']):.1f} events/s "
              f"(range {min(e2e['events_per_s']):.1f}-{max(e2e['events_per_s']):.1f}); "
              f"prong slots {r['prong_slots']}", flush=True)
        for mode in ("staged_prefetch", "staged_inline"):
            print(f"[b{batch_size}] {mode}: " + ", ".join(
                f"{k} {v:.3f}" for k, v in r[mode].items()) + " ms/batch", flush=True)
        print(f"[b{batch_size}] back to back: "
              f"{r['back_to_back_ms_per_batch']:.3f} ms/batch", flush=True)
        print(f"[b{batch_size}] profile: {json.dumps(r['profile'])}", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
