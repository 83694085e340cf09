"""The quality-parity runbook with the port as "ours": the port of
``tools/parity_run.py`` and, with ``--smoke``, of ``tools/parity_smoke.py``.

    python -m dune_transformercvn_torch.parity_run --data f.h5 --options o.json
        [--steps 2000] [--workdir d] [--device cuda|cpu] [--ours_only]
        [--from_jax JAX_RUN_DIR] [--reference REFERENCE_CHECKOUT]
        [--reference_python PY] [--fail_above 1e-3]
    python -m dune_transformercvn_torch.parity_run --smoke [--steps 12]
        [--events 257] [--device cuda|cpu]

The bar (``BASELINE.json``): event and prong AUC and confusion matrices
agree to 1e-3 when both frameworks train with the same option file on the
same data.  Stages, each skipped when its artifact exists (so trainings
may run on different machines against one ``--workdir``):

1. ours: ``python -m dune_transformercvn_torch.train --max_steps N`` ->
   ``<workdir>/ours/parity/version_N``;
2. ours: ``python -m dune_transformercvn_torch.evaluate --checkpoint last``
   -> ``eval_predictions.h5``, scored by the port's
   ``evaluation.evaluate_predictions`` (exact rank-statistic AUC);
3. reference: ``<reference>/train.py --options_file ...`` in the
   reference's own environment (torch, Lightning, MinkowskiEngine);
4. reference: batched inference with the reference's network and
   checkpoint over its validation loader (its ``shared_step``), scored
   with the same ``evaluate_predictions``;
5. diff: both tables and the deltas; exit 1 if the worst AUC delta is
   above ``--fail_above``.

Stages 3-4 are ``tools/parity_run.py``'s own, loaded from that file (the
reference side is framework-neutral; ``tools/parity_run.md``) and scored
here; they need the reference's stack, which is not on the hosts this
repo runs on.  ``--ours_only`` runs stages 1-2 (and ``--from_jax``).
``--from_jax RUN_DIR`` adds a stage the JAX runbook
cannot have: the JAX-trained run dir taken over by the port
(``tools/jax_run_to_torch.py``, run as a subprocess: it reads orbax with
JAX, which this package does not import), evaluated by stage 2's command
and scored with the same yardstick, beside ours.

``--smoke`` proves stages 1-2 run at this tree: a synthetic file (seed 7;
or ``--data``) and the tutorial option file cut to tiny widths,
``--ours_only``, the scores written to ``<workdir>/parity_run_smoke.json``.
The CLIs read HDF5 with ``h5py``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from typing import Dict

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE_OPTIONS = os.path.join(REPO, "option_files",
                             "fdhd_beam_2018prod_aiml_tutorial_2025_04_21.json")
# the smoke proves the plumbing, not quality: a small network
TINY_OVERRIDES = {
    "hidden_dim": 32,
    "initial_pixel_dim": 16,
    "pixel_embedding_dim": 32,
    "feature_embedding_dim": 16,
    "position_embedding_dim": 8,
    "final_decoder_dim": 8,
    "num_encoder_layers": 2,
    "num_prong_decoder_layers": 2,
    "num_attention_heads": 4,
    "densenet_structure": [1, 1],
    "densenet_growth_rate": 8,
    "batch_size": 4,
    "epochs": 1,
}


def sh(cmd, **kw):
    print("+", " ".join(cmd), flush=True)
    subprocess.run(cmd, check=True, **kw)


def version_key(name):
    # version_10 sorts after version_9
    tail = name.rsplit("_", 1)[-1]
    return (int(tail), name) if tail.isdigit() else (-1, name)


def train_ours(args) -> str:
    """Stage 1: the port's train CLI; returns the newest run dir."""
    run_root = os.path.join(args.workdir, "ours")
    if not os.path.isdir(run_root):
        sh([sys.executable, "-m", "dune_transformercvn_torch.train",
            "-o", args.options, "-n", "parity", "-l", run_root,
            "--max_steps", str(args.steps), "-v", "--training_file", args.data,
            "--device", args.device], cwd=REPO)
    versions = sorted(os.listdir(os.path.join(run_root, "parity")), key=version_key)
    return os.path.join(run_root, "parity", versions[-1])


def eval_ours(args, run_dir: str) -> Dict[str, np.ndarray]:
    """Stage 2: the port's evaluate CLI on the last checkpoint."""
    out = os.path.join(run_dir, "eval_predictions.h5")
    if not os.path.exists(out):
        sh([sys.executable, "-m", "dune_transformercvn_torch.evaluate", run_dir,
            "--checkpoint", "last", "--device", args.device], cwd=REPO)
    import h5py

    with h5py.File(out, "r") as f:
        return {k: f[k][...] for k in f.keys()}


def take_over_jax(args) -> str:
    """The JAX-trained run dir converted to a port run dir."""
    out = os.path.join(args.workdir, "from_jax")
    if not os.path.isdir(out):
        sh([sys.executable, os.path.join(REPO, "tools", "jax_run_to_torch.py"),
            args.from_jax, out, "--training_file", args.data], cwd=REPO)
    return out


def reference_stages():
    """Stages 3-4 as ``tools/parity_run.py`` runs them (its
    ``train_reference`` and ``eval_reference``: the reference's train CLI,
    then inference with its network and checkpoint over its validation
    loader).  They import neither JAX nor the JAX package."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "tools_parity_run", os.path.join(REPO, "tools", "parity_run.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool.train_reference, tool.eval_reference


def score(preds) -> Dict:
    from .evaluation import evaluate_predictions

    return evaluate_predictions(
        preds["event_probabilities"], preds["event_targets"],
        preds["prong_probabilities"], preds["prong_targets"],
    )


def scalars(results: Dict) -> Dict[str, float]:
    return {k: float(v) for k, v in results.items() if np.isscalar(v)}


def show(title: str, values: Dict):
    print(f"\n== {title} ==")
    print(json.dumps(values, indent=2, default=float), flush=True)


def worst_auc_delta(ours: Dict, theirs: Dict, title: str) -> float:
    deltas = {k: abs(float(ours[k]) - float(theirs[k])) for k in ours
              if np.isscalar(ours.get(k)) and np.isscalar(theirs.get(k))}
    show(f"|delta| ours - {title}", deltas)
    return max((v for k, v in deltas.items() if "auc" in k.lower()), default=0.0)


def run(args) -> Dict[str, Dict]:
    """The stages ``args`` ask for; returns the scores by run (``ours``,
    ``from_jax``, ``reference``).  Exits 1 past ``--fail_above``."""
    # the stages run from the repository's root
    for name in ("data", "options", "workdir", "from_jax"):
        if getattr(args, name):
            setattr(args, name, os.path.abspath(getattr(args, name)))
    os.makedirs(args.workdir, exist_ok=True)
    scores = {"ours": score(eval_ours(args, train_ours(args)))}
    show("ours", scalars(scores["ours"]))
    worst = 0.0
    if args.from_jax:
        scores["from_jax"] = score(eval_ours(args, take_over_jax(args)))
        show("from_jax", scalars(scores["from_jax"]))
        worst_auc_delta(scores["ours"], scores["from_jax"], "from_jax")
    if not args.ours_only:
        train_reference, eval_reference = reference_stages()
        scores["reference"] = score(eval_reference(args, train_reference(args)))
        show("reference", scalars(scores["reference"]))
        worst = worst_auc_delta(scores["ours"], scores["reference"], "reference")
        if worst > args.fail_above:
            print(f"FAIL: worst AUC delta {worst:.5f} > {args.fail_above}")
            sys.exit(1)
        print(f"OK: worst AUC delta {worst:.5f} <= {args.fail_above}")
    return scores


def smoke(args) -> Dict[str, Dict]:
    """Stages 1-2 (and ``--from_jax``) on a synthetic file, or ``--data``,
    with the tutorial option file cut to tiny widths; writes
    ``<workdir>/parity_run_smoke.json`` and returns the scores."""
    from .data.schema import make_synthetic_file

    args.workdir = args.workdir or tempfile.mkdtemp(prefix="parity_smoke_")
    os.makedirs(args.workdir, exist_ok=True)
    args.data = args.data or make_synthetic_file(
        os.path.join(args.workdir, "synthetic.h5"), num_events=args.events, seed=7)
    with open(SMOKE_OPTIONS) as f:
        opts = json.load(f)
    opts.update(TINY_OVERRIDES)
    args.options = os.path.join(args.workdir, "tiny_options.json")
    with open(args.options, "w") as f:
        json.dump(opts, f, indent=1)
    args.ours_only = True
    scores = run(args)
    record = {
        "bench": "parity_run_ours_stages_smoke",
        "command": ("python -m dune_transformercvn_torch.parity_run --smoke "
                    f"--steps {args.steps} --events {args.events} --device {args.device}"),
        "stages_executed": [
            f"train_ours (python -m dune_transformercvn_torch.train --max_steps {args.steps})",
            "eval_ours (python -m dune_transformercvn_torch.evaluate --checkpoint last)",
            "score (dune_transformercvn_torch.evaluation.evaluate_predictions)",
        ],
        "ours_metrics": scalars(scores["ours"]),
        **({"from_jax_metrics": scalars(scores["from_jax"])} if args.from_jax else {}),
        "note": ("proves the runbook's port stages at this tree; stages 3-5 need the "
                 "reference's torch/Lightning/MinkowskiEngine stack (tools/parity_run.md)"),
    }
    out = os.path.join(args.workdir, "parity_run_smoke.json")
    with open(out, "w") as f:
        json.dump(record, f, indent=1)
    print(json.dumps(record))
    print(f"# record -> {out}")
    return scores


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--data", default=None, help="fdhd HDF5 file")
    ap.add_argument("--options", default=None, help="shared option file")
    ap.add_argument("--steps", type=int, default=None,
                    help="training steps (default 2000; 12 with --smoke)")
    ap.add_argument("--reference", default=None,
                    help="a checkout of the reference repository (stages 3-5)")
    ap.add_argument("--reference_python", default=sys.executable,
                    help="python of the env that can run the reference "
                         "(torch + Lightning + MinkowskiEngine)")
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="device of the port's stages (default cuda; no fallback)")
    ap.add_argument("--fail_above", type=float, default=1e-3,
                    help="max |delta AUC| tolerated (BASELINE.json bar)")
    ap.add_argument("--ours_only", action="store_true",
                    help="run the port's stages only (1-2, and --from_jax)")
    ap.add_argument("--from_jax", default=None,
                    help="a JAX Trainer's run dir, taken over by the port and scored too")
    ap.add_argument("--smoke", action="store_true",
                    help="stages 1-2 on a synthetic file at tiny widths")
    ap.add_argument("--events", type=int, default=257, help="--smoke's synthetic events")
    args = ap.parse_args(argv)
    if args.smoke:
        args.steps = args.steps or 12
        return smoke(args)
    if not (args.data and args.options):
        ap.error("--data and --options are required (or --smoke)")
    if not (args.ours_only or args.reference):
        ap.error("stages 3-5 need --reference (or --ours_only)")
    args.steps = args.steps or 2000
    args.workdir = args.workdir or os.path.join(tempfile.gettempdir(), "parity_run")
    return run(args)


if __name__ == "__main__":
    main()
