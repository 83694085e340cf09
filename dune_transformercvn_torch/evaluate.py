"""Evaluation CLI of the port, with the flags of the repository's
``evaluate.py`` plus ``--device``:

    python -m dune_transformercvn_torch.evaluate <run_dir>
        [--checkpoint best|last|<path>] [--split validation|testing]
        [--testing_file f.h5] [--output eval_predictions.h5] [--history]
        [--plots] [--device cuda|cpu]

Loads the run's resolved ``options.json``, rebuilds the model and datasets,
restores the requested checkpoint, runs batched inference over the split,
prints accuracy / precision / recall / weighted one-vs-rest ROC-AUC (overall
and per class) with confusion matrices, and writes ``eval_predictions.h5``
(``h5py``) and, with ``--plots``, ROC and confusion PNGs (``matplotlib``).
:func:`evaluate_run` is the same flow without the files, for callers that
bring their own datasets.
"""

from __future__ import annotations

import os
from argparse import ArgumentParser
from typing import Dict, Optional, Tuple

import numpy as np

from .config import Options
from .data.schema import EVENT_CLASS_NAMES, PRONG_CLASS_NAMES
from .evaluation import evaluate_predictions, render_report


def event_class_names(predictions: Dict[str, np.ndarray]):
    """Keyed on the model's output width, not on which targets occur in the
    split (a detailed model evaluated on a coarse-only sample still gets a
    row for each of its columns)."""
    width = predictions["event_probabilities"].shape[1]
    return EVENT_CLASS_NAMES if width == len(EVENT_CLASS_NAMES) else [
        f"class_{i}" for i in range(width)]


def evaluate_run(
    run_dir: str,
    checkpoint: str = "best",
    split: str = "validation",
    batch_size: Optional[int] = None,
    device=None,
    datasets=None,
    testing_file: Optional[str] = None,
    compile: bool = False,
    graph: bool = False,
) -> Tuple[Dict[str, np.ndarray], Dict[str, object], str]:
    """Restore ``checkpoint`` ('best', 'last' or a path) of the run in
    ``run_dir`` and predict ``split``; returns ``(predictions, results,
    report)``.  ``datasets`` takes the place of the option file's HDF5
    splits, as it does for :class:`.train.Trainer`; ``compile`` predicts
    through the compiled step, ``graph`` through the CUDA graph step (a
    checkpoint of either optimizer form restores: nothing steps)."""
    from .train import CheckpointManager, Trainer

    options = Options.load(os.path.join(run_dir, "options.json"))
    if testing_file:
        options.testing_file = testing_file
        split = "testing"
    if batch_size:
        options.batch_size = batch_size

    trainer = Trainer(options, run_dir=None, debug=True, verbose=False,
                      device=device, datasets=datasets, compile=compile)
    if checkpoint in ("best", "last"):
        mgr = CheckpointManager(os.path.join(run_dir, "checkpoints"),
                                top_k=options.checkpoint_top_k)
        step = mgr.best_step() if checkpoint == "best" else mgr.latest_step()
        print(f"Restoring {checkpoint} checkpoint: step {step}")
        mgr.restore(trainer.state, step)
    else:
        trainer.resume(checkpoint)

    predictions = trainer.predict_split(split, graph=graph)
    results = evaluate_predictions(
        predictions["event_probabilities"], predictions["event_targets"],
        predictions["prong_probabilities"], predictions["prong_targets"],
    )
    report = render_report(results, event_class_names(predictions), PRONG_CLASS_NAMES)
    return predictions, results, report


def main(argv=None):
    parser = ArgumentParser(description=__doc__)
    parser.add_argument("run_dir", help="training run directory (version_N)")
    parser.add_argument("--checkpoint", default="best",
                        help="'best', 'last', or an explicit checkpoint path")
    parser.add_argument("--split", default="validation",
                        choices=["training", "validation", "testing"])
    parser.add_argument("--testing_file", default=None,
                        help="evaluate this file as the testing split")
    parser.add_argument("--output", default=None,
                        help="predictions h5 path (default <run_dir>/eval_predictions.h5)")
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--history", action="store_true",
                        help="print the logged training history and exit")
    parser.add_argument("--plots", action="store_true",
                        help="write ROC-curve and confusion-matrix PNGs")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        help="device to evaluate on (default cuda; no fallback)")
    parser.add_argument("--compile", action="store_true",
                        help="predict through the compiled step (torch.compile, Inductor)")
    parser.add_argument("--cuda_graph", action="store_true",
                        help="predict through CUDA graphs, one a batch shape")
    args = parser.parse_args(argv)

    if args.history:
        from .train.logging import read_history

        for tag, series in sorted(read_history(args.run_dir).items()):
            last_step, last_val = series[-1]
            print(f"{tag:32} {len(series):6d} points, last @ {last_step}: {last_val:.6f}")
        return

    predictions, _, report = evaluate_run(
        args.run_dir, args.checkpoint, args.split, args.batch_size, args.device,
        testing_file=args.testing_file, compile=args.compile, graph=args.cuda_graph)
    print(report)

    from .evaluation import save_plots, save_predictions_h5

    # write the (expensive) predictions before any plotting can fail
    output = args.output or os.path.join(args.run_dir, "eval_predictions.h5")
    save_predictions_h5(
        output,
        predictions["event_probabilities"], predictions["event_targets"],
        predictions["prong_probabilities"], predictions["prong_targets"],
        predictions["prong_event_index"],
    )
    print(f"Predictions written to {output}")

    if args.plots:
        written = save_plots(
            os.path.join(args.run_dir, "plots"),
            predictions["event_probabilities"], predictions["event_targets"],
            predictions["prong_probabilities"], predictions["prong_targets"],
            event_class_names(predictions), PRONG_CLASS_NAMES,
        )
        for path in written:
            print(f"Plot written: {path}")


if __name__ == "__main__":
    main()
