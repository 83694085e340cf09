#!/usr/bin/env python
"""Take a run of the JAX package's ``Trainer`` over into the PyTorch port.

    python tools/jax_run_to_torch.py <jax_run_dir> <port_run_dir>
        [--training_file f.h5]

Reads the JAX run dir (``options.json``, ``metrics.jsonl`` and the orbax
checkpoints under ``checkpoints/`` with their ``index.json``) and writes a
run dir of ``dune_transformercvn_torch``: ``options.json``,
``metrics.jsonl`` copied, and each indexed checkpoint as
``checkpoints/step_N/state.pt`` with ``index.json`` in the layout of the
port's ``train/checkpoint.py``, with the same ``val_epoch_AUC`` metrics,
top-k and last step.  The port then serves it (``python -m
dune_transformercvn_torch.evaluate <port_run_dir>``) or resumes it
(``python -m dune_transformercvn_torch.train -c <port_run_dir>/checkpoints/step_N``).

What each checkpoint carries over:

* parameters and BatchNorm statistics, through the port's
  ``from_jax.state_dict_from_jax``;
* the dataset's normalisation statistics and the step, which is also the
  learning-rate schedule's step;
* the optimizer's state: AdamW's moments (``mu``, ``nu`` of optax's
  ``ScaleByAdamState``) and count as ``torch.optim.AdamW``'s ``exp_avg``,
  ``exp_avg_sq`` and ``step``; each of the seven optax chains' slots under
  optax's names (adam and lamb ``mu``/``nu``, rmsprop ``nu``, adagrad
  ``sum_of_squares``, lars ``trace``, lion ``mu``; sgd none) and its count,
  each moment tree mapped as the parameters are.  An optimizer state that
  does not hold exactly the slots the port's optimizer keeps raises,
  naming the optimizer, rather than resume with zeroed moments.

JAX's PRNG key has no counterpart in the port (README "Random streams
differ"): each converted checkpoint holds the generator state a fresh port
run of the same options starts from, and the tool says so.

The port package itself imports no JAX; this tool reads orbax with JAX and
imports both packages.  It builds the port's ``Trainer`` on the CPU over
the option file's training file (``--training_file`` overrides it) to
take the model's shapes and the optimizer's layout from.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
from typing import Dict, List, Mapping

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

# optax's state fields holding moment trees, by the port's optimizer: the
# field names of the one optax state node that must hold them (its count,
# where it has one, beside them)
SLOT_NODES = {
    "adamw": {"count", "mu", "nu"},
    "adam": {"count", "mu", "nu"},
    "lamb": {"count", "mu", "nu"},
    "rmsprop": {"nu"},
    "adagrad": {"sum_of_squares"},
    "lars": {"trace"},
    "lion": {"count", "mu"},
    "sgd": None,
}
ADAMW_SLOTS = {"mu": "exp_avg", "nu": "exp_avg_sq"}


def restore_raw(path: str) -> Dict:
    """An orbax checkpoint of the JAX ``TrainState`` as nested dicts and
    lists of numpy arrays (no template: optax's named tuples come back as
    dicts of their fields)."""
    import orbax.checkpoint as ocp

    return ocp.StandardCheckpointer().restore(os.path.abspath(path))


def _walk(tree, path=()):
    """Every dict node of ``tree`` with its path."""
    if isinstance(tree, Mapping):
        yield path, tree
        for key, value in tree.items():
            yield from _walk(value, path + (key,))
    elif isinstance(tree, (list, tuple)):
        for i, value in enumerate(tree):
            yield from _walk(value, path + (i,))


def optimizer_slots(opt_state, name: str, params: Mapping):
    """``({slot: JAX tree}, count)`` from the restored optax state of the
    port's optimizer ``name``.  Raises unless the state holds exactly one
    node with the fields ``SLOT_NODES[name]`` and no other tree shaped as
    the parameters, and unless its counts agree."""
    def params_shaped(value):
        return isinstance(value, Mapping) and set(value) == set(params)

    moment_nodes = [(path, node) for path, node in _walk(opt_state)
                    if any(params_shaped(v) for v in node.values())]
    want = SLOT_NODES[name]
    found = [node for _, node in moment_nodes if set(node) == want]
    mappable = not moment_nodes if want is None else len(found) == len(moment_nodes) == 1
    if not mappable:
        held = sorted({k for _, node in moment_nodes for k, v in node.items()
                       if params_shaped(v)})
        raise ValueError(
            f"cannot map the optimizer state of this JAX run onto the port's {name!r}: "
            f"it holds the moment trees {held}, the port's {name} keeps "
            f"{sorted(k for k in want or () if k != 'count')} (one optax state node "
            "with those fields); not resuming with zeroed moments")
    counts = {int(np.asarray(node["count"])) for _, node in _walk(opt_state)
              if "count" in node and np.ndim(node["count"]) == 0}
    if len(counts) != 1:
        raise ValueError(f"the JAX optimizer state of {name!r} holds the counts {counts}")
    slots = {} if want is None else {k: v for k, v in found[0].items() if k != "count"}
    return slots, counts.pop()


def mapped_moments(tree, batch_stats, cfg, model) -> Dict[str, torch.Tensor]:
    """A moment tree shaped as the JAX parameters, by port parameter name,
    mapped as the parameters are (kernels transposed, q/k/v packed)."""
    from dune_transformercvn_torch.from_jax import state_dict_from_jax

    sd = state_dict_from_jax({"params": tree, "batch_stats": batch_stats}, cfg)
    return {name: sd[name] for name, _ in model.named_parameters()}


def load_optimizer(state, name: str, slots: Mapping, count: int, batch_stats, cfg):
    """Put the mapped slots and count into the port state's optimizer."""
    model, optimizer = state.model, state.optimizer
    params = dict(model.named_parameters())
    moments = {slot: mapped_moments(tree, batch_stats, cfg, model)
               for slot, tree in slots.items()}
    if name == "adamw":
        for pname, p in params.items():
            optimizer.state[p] = {
                "step": torch.tensor(float(count)),
                **{ADAMW_SLOTS[slot]: moments[slot][pname].to(p) for slot in moments},
            }
        return
    for pname, p in params.items():
        live = optimizer.state[p]
        assert set(live) == set(moments), (name, sorted(live), sorted(moments))
        for slot, values in moments.items():
            live[slot].copy_(values[pname])
    optimizer.count.fill_(count)


def convert_checkpoint(path: str, trainer, name: str, generator_state) -> int:
    """Load one JAX checkpoint into ``trainer.state`` in place; returns its
    step."""
    raw = restore_raw(path)
    state, cfg = trainer.state, trainer.model_config
    params, batch_stats = raw["params"], raw.get("batch_stats", {})
    from dune_transformercvn_torch.from_jax import load_jax_variables

    load_jax_variables(state.model, {"params": params, "batch_stats": batch_stats})
    slots, count = optimizer_slots(raw["opt_state"], name, params)
    step = int(np.asarray(raw["step"]))
    if count != step:
        raise ValueError(f"{path}: the optimizer's count {count} is not the step {step}")
    load_optimizer(state, name, slots, count, batch_stats, cfg)
    for key, value in raw["norm"].items():
        state.norm[key] = torch.as_tensor(np.asarray(value)).to(state.norm[key])
    state.step = step
    state.generator.set_state(generator_state)
    return step


def convert(jax_run_dir: str, out_dir: str, training_file: str = None) -> List[int]:
    """Write the port run dir; returns the converted steps."""
    from dune_transformercvn_torch import Options
    from dune_transformercvn_torch.train import CheckpointManager, Trainer
    from dune_transformercvn_torch.train.optimizer import optimizer_name

    options = Options.load(os.path.join(jax_run_dir, "options.json"))
    if training_file:
        options.training_file = training_file
    with open(os.path.join(jax_run_dir, "checkpoints", "index.json")) as f:
        index = json.load(f)
    if not index["checkpoints"]:
        raise FileNotFoundError(f"no checkpoints indexed in {jax_run_dir}")
    name = optimizer_name(options)
    trainer = Trainer(options, run_dir=None, debug=True, verbose=False, device="cpu")
    generator_state = trainer.state.generator.get_state()

    os.makedirs(out_dir, exist_ok=True)
    options.save(os.path.join(out_dir, "options.json"))
    metrics = os.path.join(jax_run_dir, "metrics.jsonl")
    if os.path.exists(metrics):
        shutil.copyfile(metrics, os.path.join(out_dir, "metrics.jsonl"))
    manager = CheckpointManager(os.path.join(out_dir, "checkpoints"),
                                top_k=options.checkpoint_top_k)
    steps = []
    for entry in sorted(index["checkpoints"], key=lambda c: c["step"]):
        jax_path = os.path.join(jax_run_dir, "checkpoints", f"step_{entry['step']}")
        step = convert_checkpoint(jax_path, trainer, name, generator_state)
        manager.save(trainer.state, step, entry["metric"])
        steps.append(step)
    assert manager.latest_step() == index["last"], (manager.latest_step(), index["last"])
    print(f"converted {name} run {jax_run_dir} -> {out_dir}: steps {steps}, last "
          f"{index['last']}, best {manager.best_step()}")
    print("note: JAX's PRNG key has no counterpart in the port; each checkpoint holds "
          f"the generator state a fresh port run starts from (seed {options.seed}), so "
          "dropout and pixel noise draw the port's own streams from the resume on")
    return steps


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("jax_run_dir", help="a JAX Trainer's run dir (version_N)")
    parser.add_argument("out_dir", help="the port run dir to write")
    parser.add_argument("--training_file", default=None,
                        help="the HDF5 file in place of the option file's training_file")
    args = parser.parse_args(argv)
    import jax

    jax.config.update("jax_platforms", "cpu")
    convert(args.jax_run_dir, args.out_dir, args.training_file)


if __name__ == "__main__":
    main()
