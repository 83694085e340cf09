"""Checkpointing: save and restore of the full train state with top-k
retention.

Port of ``dune_transformercvn_tpu/train/checkpoint.py`` with ``torch.save``
in place of orbax.  It replaces Lightning's ModelCheckpoint configuration
(train.py:107-114): a checkpoint every validation, the top-k by
``val_epoch_AUC`` kept plus the most recent one ("last"), and a restore of
the full train state -- parameters, BatchNorm buffers, the optimizer's
state (AdamW's moments and step counts, or an optax chain's slots and
count), the step, the dataset normalization statistics and the generator's
state -- so resume continues exactly (epoch shuffling is re-derived
deterministically from (seed, epoch)).

Layout, as the JAX package's: ``<dir>/step_{N}/`` per save (here holding
``state.pt``) and ``<dir>/index.json`` = ``{"checkpoints": [{"step",
"metric", "path"}], "last"}``, which ``utils.rundir.find_resumable`` reads.
Files are read with ``torch.load(weights_only=True)``: tensors, numbers,
strings and containers only, never arbitrary pickled objects.

With tensor parallelism (``parallel.shard_parameters``) a checkpoint holds
whole tensors, as the JAX package's do, so it stays independent of the
layout: :func:`to_host` gathers the sharded parameters, BatchNorm
statistics and moments, which
every rank of a TP row must join (the Trainer makes the copy on every rank
and rank 0 writes it), and a restore cuts each rank's pieces back out.

Not ported: the JAX package's restore that tolerates a PRNG-impl change
(its ``_restore_rng_tolerant``).  It exists because raw JAX key shapes
differ between XLA's PRNG implementations; the port's generator state has
one layout.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from ..parallel import full_tensors

STATE_FILE = "state.pt"


def to_host(tree):
    """A copy of ``tree`` with every tensor copied to host memory (a new
    tensor even where it already is there), so the caller may go on
    updating the live state while the copy is kept.  Sharded tensors are
    gathered whole, in one collective of their TP row."""
    leaves, spec = tree_flatten(tree)
    where = [i for i, leaf in enumerate(leaves) if torch.is_tensor(leaf)]
    for i, whole in zip(where, full_tensors([leaves[i] for i in where])):
        leaves[i] = whole.detach().to("cpu", copy=True)
    return tree_unflatten(leaves, spec)


def restore_from_path(path: str, state):
    """Load a single checkpoint directory (``step_{N}``) into ``state`` in
    place, onto the device of its model (the ``-c path`` resume flow)."""
    saved = torch.load(os.path.join(os.path.abspath(path), STATE_FILE),
                       map_location=next(state.model.parameters()).device,
                       weights_only=True)
    state.load_state_dict(saved)
    return state


class CheckpointManager:
    """Minimal, robust top-k checkpoint manager over ``torch.save``."""

    def __init__(self, directory: str, top_k: int = 5, metric: str = "val_epoch_AUC"):
        self.directory = os.path.abspath(directory)
        self.top_k = top_k
        self.metric = metric
        os.makedirs(self.directory, exist_ok=True)
        self._index_path = os.path.join(self.directory, "index.json")
        self._index: Dict[str, Any] = {"checkpoints": [], "last": None}
        if os.path.exists(self._index_path):
            with open(self._index_path) as f:
                self._index = json.load(f)

    # -------------------------------------------------------------------------

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}")

    def _write_index(self):
        with open(self._index_path, "w") as f:
            json.dump(self._index, f, indent=2)

    def save(self, state, step: int, metric_value: Optional[float] = None, host=None):
        """Write ``state`` (a ``TrainState``) as checkpoint ``step``, index
        it and prune beyond top-k (never pruning 'last').  ``host``: the
        state's :func:`to_host` copy when the caller made it (a sharded
        state's copy is made on every rank of its TP row).

        The write is synchronous: at the production width (~70 MB) it takes
        about half a second on an H100 host, a small share of an eval
        interval (PERF.md §6)."""
        path = self._path(step)
        if os.path.exists(path):
            shutil.rmtree(path)
        os.makedirs(path)
        target = os.path.join(path, STATE_FILE)
        torch.save(to_host(state.state_dict()) if host is None else host, target + ".tmp")
        os.replace(target + ".tmp", target)
        entry = {"step": int(step), "metric": metric_value, "path": path}
        self._index["checkpoints"] = [
            c for c in self._index["checkpoints"] if c["step"] != entry["step"]
        ] + [entry]
        self._index["last"] = entry["step"]
        self._prune()
        self._write_index()
        return path

    @staticmethod
    def _rank_metric(entry) -> float:
        """None/NaN metrics rank below every real value (pruned first)."""
        metric = entry.get("metric")
        if metric is None or (isinstance(metric, float) and np.isnan(metric)):
            return -np.inf
        return float(metric)

    def _prune(self):
        ranked = sorted(
            self._index["checkpoints"], key=self._rank_metric, reverse=True
        )
        keep = {c["step"] for c in ranked[: self.top_k]}
        keep.add(self._index["last"])
        for c in list(self._index["checkpoints"]):
            if c["step"] not in keep:
                shutil.rmtree(c["path"], ignore_errors=True)
                self._index["checkpoints"].remove(c)

    # -------------------------------------------------------------------------

    def latest_step(self) -> Optional[int]:
        return self._index.get("last")

    def ranked_best_step(self) -> Optional[int]:
        """The step of the best metric; None when no checkpoint has one."""
        entries = [
            c for c in self._index["checkpoints"]
            if self._rank_metric(c) != -np.inf
        ]
        return max(entries, key=self._rank_metric)["step"] if entries else None

    def best_step(self) -> Optional[int]:
        """The step of the best metric, else the latest step."""
        best = self.ranked_best_step()
        return self.latest_step() if best is None else best

    def restore(self, state, step: Optional[int] = None):
        """Load checkpoint ``step`` (default: the latest) into ``state`` (a
        freshly built ``TrainState``) in place, and return it."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        return restore_from_path(self._path(step), state)
