"""Import a trained reference checkpoint into a port run dir.

Port of ``dune_transformercvn_tpu/torch_import.py``.  A user of the
reference (ayankele/dune-transformercvn) arrives with PyTorch Lightning
checkpoints (reference train.py:107-114): a ``state_dict`` holding the
network under the trainer's ``network.`` prefix
(neutrino_full_base_trainer.py:55) and the frozen normalization statistics
``mean`` / ``std`` / ``extra_mean`` / ``extra_std`` (neutrino_base.py:32-45),
plus ``global_step``.  The port's modules carry the reference's names, so
the network's tensors load into the port's ``TransformerCVN`` by name:
:func:`import_reference_checkpoint` checks that every parameter and buffer
of the model built from the option file is given exactly once, with its
shape, and writes a run dir (``options.json`` + a ``step_{global_step}``
checkpoint) that ``evaluate`` and ``export`` read.

A missing network tensor, or one the model has no place for, raises
``KeyError`` naming it; a shape mismatch raises ``ValueError`` (the wrong
option file for the checkpoint, e.g. a ReLU-trained checkpoint under PReLU
options).  Two kinds of reference tensors have no counterpart and are
skipped: BatchNorm's ``num_batches_tracked``, and the feature-embedding
stack the reference creates even with ``disable_smart_features`` set.

Only the dense family is importable (``options.embedder == "dense"``): the
reference's production checkpoints are dense.  AdamW's moments are not
carried over; the checkpoint holds a fresh optimizer and the file's
``global_step``.  ``torch.load`` unpickles the file, so import only
checkpoints you trust.

The conversion takes no device, the one entry point of the port without
``--device``: it runs no network and no kernel (it reads tensors, checks
their names and shapes, and writes files), so what it writes does not
depend on a device.  It holds the model on the CPU, and the run dir it writes is restored
on the device that ``evaluate`` or ``export`` is given, the card by
default.

CLI::

    python -m dune_transformercvn_torch.torch_import ckpt.ckpt \\
        -o options.json --out imported/version_0
    python -m dune_transformercvn_torch.evaluate imported/version_0 --checkpoint last
"""

from __future__ import annotations

import os
from typing import Dict, Mapping, Optional

import numpy as np
import torch

_NORM_KEYS = ("mean", "std", "extra_mean", "extra_std")
_DISABLED_FEATURES = "prong_embedding.feature_embedding."


def strip_network_prefix(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Lightning trainer checkpoints hold the network under ``network.``;
    bare network ``state_dict``s do not.  The normalization statistics stay
    top-level either way."""
    if not any(key.startswith("network.") for key in sd):
        return dict(sd)
    return {key[len("network."):] if key.startswith("network.") else key: value
            for key, value in sd.items()}


def extract_norm(sd: Mapping[str, torch.Tensor]) -> Optional[Dict[str, np.ndarray]]:
    """The frozen normalization statistics, if the checkpoint was trained
    with ``normalize_features``."""
    if not all(k in sd for k in _NORM_KEYS):
        return None
    return {k: sd[k].detach().cpu().numpy().copy() for k in _NORM_KEYS}


def network_state_dict(sd: Mapping[str, torch.Tensor],
                       template: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The tensors of ``sd`` (prefix stripped) for each entry of the port
    model's ``template`` ``state_dict``, checked name by name and shape by
    shape."""
    net = {k: v for k, v in sd.items() if k not in _NORM_KEYS}
    missing = [k for k in template if k not in net]
    if missing:
        raise KeyError(f"checkpoint lacks {len(missing)} tensor(s) of the model, e.g. "
                       f"{missing[:4]} -- the option file's architecture does not match "
                       "the checkpoint")
    features_disabled = not any(k.startswith(_DISABLED_FEATURES) for k in template)
    extra = [k for k in net if k not in template
             and not k.endswith("num_batches_tracked")
             and not (features_disabled and k.startswith(_DISABLED_FEATURES))]
    if extra:
        raise KeyError(f"checkpoint has {len(extra)} tensor(s) with no place in the model, "
                       f"e.g. {extra[:4]} -- the option file's architecture does not "
                       "match the checkpoint")
    for key, want in template.items():
        if net[key].shape != want.shape:
            raise ValueError(f"shape mismatch at {key}: checkpoint "
                             f"{tuple(net[key].shape)}, model {tuple(want.shape)}")
    return {key: net[key] for key in template}


def import_reference_checkpoint(ckpt_path: str, options, out_dir: str,
                                verbose: bool = True) -> str:
    """Convert a reference checkpoint into an ``evaluate``-ready run dir;
    returns ``out_dir``.  ``options`` must describe the checkpoint's
    architecture (the reference dumps the matching ``options.json`` beside
    its logs, train.py:145-149) and point ``training_file`` at a dataset
    (the model's input widths come from it; the normalization statistics
    come from the checkpoint when it has them, else from the dataset)."""
    if getattr(options, "embedder", "dense") != "dense":
        raise ValueError("only the dense family has importable reference checkpoints "
                         f"(options.embedder = {options.embedder!r})")
    payload = torch.load(ckpt_path, map_location="cpu", weights_only=False)
    state_dict = payload.get("state_dict", payload) if isinstance(payload, dict) else payload
    global_step = int(payload.get("global_step", 0)) if isinstance(payload, dict) else 0
    sd = strip_network_prefix(state_dict)

    from .train import CheckpointManager, Trainer

    trainer = Trainer(options, run_dir=None, debug=True, verbose=False, device="cpu")
    state = trainer.state
    state.model.load_state_dict(network_state_dict(sd, state.model.state_dict()))
    norm = extract_norm(sd)
    if norm is None:
        if verbose:
            print("checkpoint carries no normalization statistics "
                  "(normalize_features off?) -- keeping the dataset's")
    else:
        for key, value in norm.items():
            want = tuple(state.norm[key].shape)
            if value.shape != want:
                raise ValueError(f"normalization statistic {key!r} shape {value.shape} "
                                 f"does not match the dataset's {want}")
        state.norm = {k: torch.from_numpy(v).to(state.norm[k].dtype) for k, v in norm.items()}
    state.step = global_step

    os.makedirs(out_dir, exist_ok=True)
    options.save(os.path.join(out_dir, "options.json"))
    CheckpointManager(os.path.join(out_dir, "checkpoints"),
                      top_k=options.checkpoint_top_k).save(state, global_step, None)
    if verbose:
        print(f"Imported {ckpt_path} (global_step {global_step}) -> {out_dir}")
        print("Evaluate with: python -m dune_transformercvn_torch.evaluate "
              f"{out_dir} --checkpoint last")
    return out_dir


def main(argv=None):
    from argparse import ArgumentParser

    from .config import Options

    parser = ArgumentParser(description=__doc__)
    parser.add_argument("checkpoint", help="reference .ckpt (Lightning) or raw state_dict")
    parser.add_argument("-o", "--options_file", required=True,
                        help="the run's options.json (dumped beside the reference logs)")
    parser.add_argument("--out", required=True,
                        help="output run directory (evaluate-compatible)")
    parser.add_argument("--training_file", default=None,
                        help="override options.training_file (dataset to build the "
                             "model against)")
    args = parser.parse_args(argv)
    options = Options.load(args.options_file)
    if args.training_file:
        options.training_file = args.training_file
    import_reference_checkpoint(args.checkpoint, options, args.out)


if __name__ == "__main__":
    main()
