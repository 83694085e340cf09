"""Sustained training on one GPU: the port of ``tools/sustained_train.py``.

    python -m dune_transformercvn_torch.sustained_train [--steps 400]
        [--events 6000] [--eval_interval 80] [--batch_size 16]
        [--cuda_graph] [--steps_per_dispatch K] [--device cuda|cpu]
        [--out FILE]

Several hundred real steps of the production option file
(``fdhd_beam_2018prod_2023_08_07.json``: dense, bfloat16, batch 16) at full
width and depth through ``Trainer.fit``: host batch assembly, the copies to
the device, the step, a validation every ``--eval_interval`` steps with the
streaming metrics, and a synchronous checkpoint after each.  The events are
those of ``make_synthetic_file`` at seed 11, the JAX tool's, made in memory
(``data.schema.make_synthetic_arrays``; the card's host may lack ``h5py``)
and split as the option file splits its training file.  ``--cuda_graph``
runs the train and validation steps as CUDA graphs, ``--steps_per_dispatch``
K steps a replay (K > 1 takes static batch shapes, as in the JAX package).

It records what the step-level readings cannot see:

* the loop's own ``events_per_second`` windows (the ``Trainer`` logs one
  every ``log_every_n_steps`` = 50 steps, at steps 1 and 2, and before each
  validation), and the steady state as the JAX tool computes it: the median
  of the second half of the windows that span no validation;
* the ``val_epoch_AUC`` curve, which must climb well above 0.5: a guard
  against learning-dynamics faults that single-step tests cannot catch
  (random streams, BatchNorm momentum, the schedule's wiring);
* the wall time, the peak device memory, and kernel K1's launches, which
  must be twice a step and twice a validation batch (plus, with CUDA
  graphs, those of each graph's warm-up before its capture); a K1 that
  fails to build or launch ends the run with an error.

Writes the record under its dispatch (``eager``, ``cuda_graph_k<K>``) into
``--out`` (default ``artifacts/sustained_train_h100.json``, other
dispatches' records kept), with the keys of the JAX tool's record and, on
the card, its ``nvidia-smi`` name and power limit.  The device is the card
unless ``--device cpu`` asks for the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import tempfile
import time
from typing import Dict, List, Mapping, Optional

import torch

from .config import Options
from .data.dataset import create_datasets
from .data.schema import make_synthetic_arrays
from .ops.densify import densify_images_cuda
from .profile_serving import OPTION_FILE

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_OUT = os.path.join(REPO, "artifacts", "sustained_train_h100.json")
JAX_RECORD = os.path.join(REPO, "artifacts", "sustained_train_v5e.json")
SEED = 11                       # the JAX tool's make_synthetic_file seed
K1_PER_STEP = 2                 # a dense step densifies the event's and the prongs' images


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def read_run(run_dir: str):
    """``(windows, auc_curve, loss_curve, eval_steps)`` from the run's
    ``metrics.jsonl``, as the JAX tool reads its run."""
    windows, auc_curve, loss_curve, eval_steps = [], [], [], set()
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            if "events_per_second" in rec:
                windows.append({"step": rec["step"],
                                "events_per_second": rec["events_per_second"]})
            if "train_loss" in rec:
                loss_curve.append({"step": rec["step"], "train_loss": rec["train_loss"]})
            if "val_epoch_AUC" in rec:
                eval_steps.add(rec["step"])
                auc_curve.append({"step": rec["step"],
                                  "val_epoch_AUC": rec["val_epoch_AUC"]})
    return windows, auc_curve, loss_curve, eval_steps


def steady_state(windows: List[Dict], eval_steps) -> float:
    """The median of the second half of the windows whose span holds no
    validation (a validation and its checkpoint land in the window after
    it), else of the second half of all windows: the JAX tool's rule."""
    prev = [0] + [w["step"] for w in windows[:-1]]
    clean = [w["events_per_second"] for w, p in zip(windows, prev)
             if not any(p <= e < w["step"] for e in eval_steps)]
    tail = sorted(clean[len(clean) // 2:] or
                  [w["events_per_second"] for w in windows[len(windows) // 2:]])
    return tail[len(tail) // 2] if tail else float("nan")


def warmup_launches(trainer) -> int:
    """K1's launches in the warm-ups before the captures of the trainer's
    CUDA graphs: one eager run of each captured graph's body, K steps for a
    train graph and one batch for a validation graph."""
    return sum(K1_PER_STEP * steps * captured
               for captured, steps in trainer.graph_captures())


def dispatch_name(graph: bool, steps_per_dispatch: int) -> str:
    return f"cuda_graph_k{steps_per_dispatch}" if graph else "eager"


def check_out(out: Optional[str]) -> None:
    if out is not None and os.path.abspath(out) == JAX_RECORD:
        raise ValueError(f"{out} is the JAX tool's record; the port writes its own")


def build(data: Mapping, eval_interval: int = 80, batch_size: int = 16,
          graph: bool = False, steps_per_dispatch: int = 1, device=None,
          options: Optional[Options] = None, workdir: Optional[str] = None,
          log_every_n_steps: int = 50, verbose: bool = True):
    """The ``Trainer`` of a sustained run over ``data`` (the training
    file's arrays by dataset name).  ``options`` (default the production
    option file) get ``batch_size``, 1,000 epochs, ``eval_interval``,
    ``steps_per_dispatch`` and ``verbose_output``."""
    from .train import Trainer

    options = Options.load(OPTION_FILE) if options is None else options
    options.batch_size = batch_size
    options.epochs = 1000           # bounded by steps
    options.eval_interval = eval_interval
    options.steps_per_dispatch = steps_per_dispatch
    options.verbose_output = True
    workdir = workdir or tempfile.mkdtemp(prefix="sustained_")
    t0 = time.time()
    trainer = Trainer(options, name="sustained", log_dir=workdir, device=device,
                      datasets=create_datasets(options, data), graph=graph, verbose=verbose,
                      log_every_n_steps=log_every_n_steps)
    print(f"# trainer built in {time.time() - t0:.1f}s; run dir {trainer.run_dir}",
          flush=True)
    return trainer


def fit(trainer, steps: int, events: int, out: Optional[str] = DEFAULT_OUT) -> Dict:
    """Fit ``trainer`` (:func:`build`'s) ``steps`` steps and return the
    record, written into ``out`` under its dispatch unless ``out`` is None;
    ``events``: the events its data holds."""
    check_out(out)
    on_card = trainer.device.type == "cuda"
    card = card_line() if on_card else None
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    launches = densify_images_cuda.launches
    t0 = time.time()
    last = trainer.fit(max_steps=steps)
    if on_card:
        torch.cuda.synchronize()
    wall = time.time() - t0
    launches = densify_images_cuda.launches - launches

    windows, auc_curve, loss_curve, eval_steps = read_run(trainer.run_dir)
    val_batches = len(trainer.val_batcher) * len(eval_steps)
    warmups = warmup_launches(trainer)
    expected = K1_PER_STEP * (trainer.state.step + val_batches) + warmups
    if on_card and launches != expected:
        raise RuntimeError(f"K1 launched {launches} times, expected {expected}: twice "
                           f"in each of {trainer.state.step} steps and {val_batches} "
                           "validation batches, plus the graphs' warm-ups")
    batch_size, steps_per_dispatch = trainer.options.batch_size, trainer.steps_per_dispatch
    name = dispatch_name(trainer.graph, steps_per_dispatch)
    record = {
        "bench": "sustained_train",
        "device": torch.cuda.get_device_name(trainer.device) if on_card else "cpu",
        "config": (
            f"production fdhd dense, batch {batch_size}, {trainer.model_config.compute_dtype}, "
            f"Trainer.fit end-to-end (host assembly + H2D + step + validation + "
            f"synchronous checkpoints), {name}"),
        "steps": trainer.state.step,
        "events": events,
        "wall_s": wall,
        "window_events_per_second": windows,
        "steady_state_events_per_second": steady_state(windows, eval_steps),
        "final_val_epoch_AUC": last.get("val_epoch_AUC", 0.0),
        "val_auc_curve": auc_curve,
        "note": (
            "windows are the training loop's own events_per_second logs (every "
            f"log_every_n_steps={trainer.log_every_n_steps} steps, at steps 1 and 2 and "
            "before each validation, metrics read one step late); steady_state is the "
            "median of validation-free second-half windows"),
        "dispatch": name,
        "steps_per_dispatch": steps_per_dispatch,
        "train_loss_curve": loss_curve,
        "peak_memory_gib": torch.cuda.max_memory_allocated(trainer.device) / 2 ** 30
        if on_card else None,
        "k1_launches": launches,
        "k1_warmup_launches": warmups,
        "validation_batches": val_batches,
        "card": card,
        "torch": torch.__version__,
    }
    if out is not None:
        records = {}
        if os.path.exists(out):
            with open(out) as f:
                records = json.load(f)
        records[name] = record
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as f:
            json.dump(records, f, indent=1)
    print(json.dumps({k: v for k, v in record.items()
                      if k not in ("window_events_per_second", "train_loss_curve")}, indent=1))
    if out is not None:
        print(f"# record -> {out}")
    return record


def run(steps: int = 400, events: int = 6000, eval_interval: int = 80,
        batch_size: int = 16, graph: bool = False, steps_per_dispatch: int = 1,
        device=None, out: Optional[str] = DEFAULT_OUT, options: Optional[Options] = None,
        data: Optional[Mapping] = None, workdir: Optional[str] = None,
        log_every_n_steps: int = 50, verbose: bool = True) -> Dict:
    """:func:`build` and :func:`fit` over ``data`` (default
    ``make_synthetic_arrays(events, seed=11)``); returns the record."""
    check_out(out)
    data = make_synthetic_arrays(events, seed=SEED) if data is None else data
    trainer = build(data, eval_interval, batch_size, graph, steps_per_dispatch, device,
                    options, workdir, log_every_n_steps, verbose)
    return fit(trainer, steps, len(data["features"]), out)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--steps", type=int, default=400)
    parser.add_argument("--events", type=int, default=6000)
    parser.add_argument("--eval_interval", type=int, default=80)
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--cuda_graph", action="store_true",
                        help="train and validate through CUDA graphs")
    parser.add_argument("--steps_per_dispatch", type=int, default=1,
                        help="K steps a call (with --cuda_graph, a replay)")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        help="device to train on (default cuda; no fallback)")
    parser.add_argument("--out", default=DEFAULT_OUT)
    args = parser.parse_args(argv)
    run(args.steps, args.events, args.eval_interval, args.batch_size, args.cuda_graph,
        args.steps_per_dispatch, args.device, args.out)


if __name__ == "__main__":
    main()
