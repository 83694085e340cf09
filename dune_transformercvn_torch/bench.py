"""The port's benchmark: serving and training throughput of the production
dense TransformerCVN on one GPU.

    python -m dune_transformercvn_torch.bench [--device cpu] [--options FILE]

Port of the root ``bench.py``.  The production option file
(``option_files/fdhd_beam_2018prod_2023_08_07.json``: DenseNet-BC
[3,6,12,6,3] growth 32, hidden 128, 6 encoder layers), the dense family,
bfloat16, random weights from seed 0, events made in memory
(:class:`.data.InMemoryEvents`, which needs no h5py).  Rows:

* ``inference_b{16,64}_{eager,compiled}``: ``predict_split`` over
  ``SERVE_EVENTS`` events (host batching and copies included) with static
  batch shapes (``fixed_shape``: one graph a batch size), one warm-up
  pass, then ``SERVE_PASSES`` timed passes: events/s (median and range)
  and peak memory.  The headline ``value`` is eager at batch 16, the
  protocol of the only published reference number (43.2 events/s,
  ``vs_baseline``).
* ``train_b{16,64}_{eager,compiled}``: the train step (forward, backward,
  clip, AdamW) on one batch of that size, reused every step as the root
  bench does: ``TRAIN_WARMUP`` steps, then ``TRAIN_WINDOWS`` windows of
  ``TRAIN_STEPS`` back-to-back steps: ms/step (median and range over the
  windows), events/s, peak memory, and ``mfu``: the step's FLOPs
  (``torch.utils.flop_counter`` over one forward and backward on the meta
  device) over its time and the card's dense bf16 peak (``PEAK_BF16_FLOPS``
  by device name; null for another card).
* ``*_compiled``: the same through ``compile=True``
  (:mod:`.utils.compile`), with ``compile_s``: the first pass or step's
  time over a timed one's, which is the compiling of every graph it met.

The step drifts 15-20% between processes, so each row reports the median
and range of repeated windows, with no profiler in the process.  A row that
runs out of device memory becomes ``<row>_oom`` with the error's first line.
Each row's wall time (its compiles included) goes to stderr.
Prints exactly one JSON line on stdout in every case: with no CUDA device
(and no ``--device cpu``) ``"error": "no_cuda"`` and ``value`` null, exit 0;
on any other failure ``"error"`` and exit 1.  ``--device cpu`` and
``--options`` exist for the tests.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from . import Options
from .data import Batcher, InMemoryEvents
from .models import ModelConfig, TransformerCVN
from .predict import predict_split, to_device
from .train import create_train_state, make_train_step
from .train.step import compute_losses
from .utils.cache import enable_compile_cache

OPTION_FILE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "option_files", "fdhd_beam_2018prod_2023_08_07.json")
BASELINE_EVENTS_PER_SECOND = 43.2   # the reference's Evaluate loop: 2.70 it/s at batch 16
UNIT = "events/s (batch 16, dense prod config, bf16, 1 GPU)"
# Dense bf16 tensor-core peaks, FLOP/s, by torch.cuda.get_device_name
# (NVIDIA's data sheets, at the full power limit).
PEAK_BF16_FLOPS = {
    "NVIDIA H100 80GB HBM3": 989.4e12,      # H100 SXM
    "NVIDIA H100 PCIe": 756.0e12,
    "NVIDIA H200": 989.4e12,
}
SEED = 0
IMAGE_SHAPE = (400, 280)
BATCH_SIZES = (16, 64)
SERVE_EVENTS = {16: 256, 64: 512}
SERVE_PASSES = 5
TRAIN_WARMUP, TRAIN_WINDOWS, TRAIN_STEPS = 3, 5, 4


def _record(**fields):
    return {"metric": "inference_events_per_second", "value": None, "unit": UNIT,
            "vs_baseline": None, **fields}


def card():
    """``(name, power limit)`` from ``nvidia-smi``; ``(None, None)`` where it
    does not answer."""
    try:
        line = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        return None, None
    name, _, limit = line.strip().splitlines()[0].partition(",")
    return name.strip(), limit.strip()


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _reset_peak(device):
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)


def _peak_gib(device):
    return torch.cuda.max_memory_allocated(device) / 2 ** 30 if device.type == "cuda" else None


def _spread(values):
    return statistics.median(values), [min(values), max(values)]


def setup(options_file, device):
    """The option file's dense network config in bfloat16, and its options."""
    options = Options.load(options_file)
    options.compute_dtype = "bfloat16"
    cfg = ModelConfig.from_options(options, features_dim=6, extra_dim=4, pixel_channels=3,
                                   num_event_classes=4, num_prong_classes=8,
                                   image_shape=IMAGE_SHAPE, embedder="dense")
    return options, cfg


def new_model(cfg, device):
    return TransformerCVN(cfg, generator=torch.Generator().manual_seed(SEED)).to(device)


def serve_row(cfg, device, batch_size, compile):
    """``predict_split`` events/s over ``SERVE_EVENTS[batch_size]`` events."""
    ds = InMemoryEvents(SERVE_EVENTS[batch_size], SEED + 1, IMAGE_SHAPE)
    model = new_model(cfg, device)
    _reset_peak(device)

    def one_pass():
        _sync(device)
        t0 = time.perf_counter()
        predict_split(model, ds, ds.norm(), batch_size, device, fixed_shape=True,
                      compile=compile)
        _sync(device)
        return time.perf_counter() - t0

    first = one_pass()
    seconds = [one_pass() for _ in range(SERVE_PASSES)]
    eps, eps_range = _spread([len(ds) / s for s in seconds])
    row = {"events_per_second": eps, "events_per_second_range": eps_range,
           "peak_gib": _peak_gib(device)}
    if compile:
        row["compile_s"] = first - statistics.median(seconds)
    return row


def step_flops(cfg, options, batch, norm):
    """FLOPs of one train step's forward and backward (matmuls, convolutions,
    attention), counted on the meta device: nothing runs."""
    from torch.utils.flop_counter import FlopCounterMode

    model = new_model(cfg, "cpu").to("meta").train()
    batch, norm = to_device(batch, "meta"), to_device(norm, "meta")
    with FlopCounterMode(display=False) as counter:
        event_logits, prong_logits = model(batch, norm)
        total, _ = compute_losses(event_logits, prong_logits, batch["event_targets"],
                                  batch["prong_targets"], options.loss_gamma,
                                  options.event_prong_loss_proportion)
        total.backward()
    return counter.get_total_flops()


def train_row(cfg, options, device, batch_size, compile, peak_flops):
    """ms/step of the train step on one batch of ``batch_size`` events."""
    ds = InMemoryEvents(batch_size, SEED + 2, IMAGE_SHAPE)
    host_batch = Batcher(ds, batch_size=batch_size).build_batch(np.arange(batch_size))
    flops = step_flops(cfg, options, host_batch, ds.norm())
    _reset_peak(device)
    batch = to_device(host_batch, device)
    model = new_model(cfg, device)
    state = create_train_state(model, options, ds.norm(), 100, seed=SEED)
    step = make_train_step(model, options, compile=compile)

    def run(n):
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(n):
            metrics = step(state, batch)
        _sync(device)
        if not np.isfinite(float(metrics["train_loss"])):
            raise FloatingPointError(f"train_b{batch_size}: loss {metrics['train_loss']}")
        return (time.perf_counter() - t0) / n

    first = run(1)
    if TRAIN_WARMUP > 1:
        run(TRAIN_WARMUP - 1)
    ms, ms_range = _spread([1e3 * run(TRAIN_STEPS) for _ in range(TRAIN_WINDOWS)])
    row = {"ms_per_step": ms, "ms_per_step_range": ms_range,
           "events_per_second": batch_size * 1e3 / ms, "peak_gib": _peak_gib(device),
           "tflops_per_step": flops / 1e12,
           "mfu": flops / (ms / 1e3) / peak_flops if peak_flops else None}
    if compile:
        row["compile_s"] = first - ms / 1e3
    return row


def _run_row(record, name, fn, device):
    """``record[name_field] = value`` for the row's fields; an out-of-memory
    error becomes ``record[name + '_oom']``.  Each row's wall time goes to
    stderr."""
    t0 = time.perf_counter()
    try:
        row = fn()
    except torch.OutOfMemoryError as error:
        row = {"oom": str(error).splitlines()[0]}
    finally:
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    record.update({f"{name}_{key}": value for key, value in row.items()})
    print(f"# {name}: {time.perf_counter() - t0:.1f} s {json.dumps(row)}",
          file=sys.stderr, flush=True)


def run(options_file, device):
    """Every row of the bench; the record without its headline filled."""
    enable_compile_cache()
    options, cfg = setup(options_file, device)
    name, limit = card() if device.type == "cuda" else ("cpu", None)
    peak = PEAK_BF16_FLOPS.get(torch.cuda.get_device_name(device)) if device.type == "cuda" \
        else None
    record = _record(device=name, power_limit=limit, torch=torch.__version__,
                     kind=torch.cuda.get_device_name(device) if device.type == "cuda"
                     else "cpu", peak_bf16_flops=peak)
    for compile in (False, True):
        mode = "compiled" if compile else "eager"
        for b in BATCH_SIZES:
            _run_row(record, f"inference_b{b}_{mode}",
                     lambda: serve_row(cfg, device, b, compile), device)
    for compile in (False, True):
        mode = "compiled" if compile else "eager"
        for b in BATCH_SIZES:
            _run_row(record, f"train_b{b}_{mode}",
                     lambda: train_row(cfg, options, device, b, compile, peak), device)
    value = record.get("inference_b16_eager_events_per_second")
    record["value"] = value
    record["vs_baseline"] = None if value is None else value / BASELINE_EVENTS_PER_SECOND
    return record


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cpu: for the tests; the bench measures a GPU")
    p.add_argument("--options", default=OPTION_FILE,
                   help="the option file (default: the production one)")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print(json.dumps(_record(error="no_cuda")), flush=True)
        return 0
    try:
        record = run(args.options, torch.device(args.device))
    except Exception as error:   # the one line is printed whatever failed
        print(json.dumps(_record(error=f"{type(error).__name__}: {error}")), flush=True)
        raise
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
