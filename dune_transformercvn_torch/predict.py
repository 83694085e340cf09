"""Batched inference: the serving path.

Port of ``make_predict_step`` (``dune_transformercvn_tpu/train/step.py``) and
``Trainer.predict_split`` (``dune_transformercvn_tpu/train/loop.py``) for one
device.  Batches come from the port's :class:`.data.Batcher`.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from .data import Batcher, split_current_targets


def to_device(arrays: Mapping[str, np.ndarray], device,
              non_blocking: bool = False) -> Dict[str, torch.Tensor]:
    """numpy arrays or host tensors (a batch, or the norm statistics) ->
    tensors on ``device``.  ``non_blocking`` copies from :func:`pinned`
    tensors do not wait for the device."""
    return {k: (v if torch.is_tensor(v) else torch.as_tensor(np.asarray(v))).to(
        device, non_blocking=non_blocking) for k, v in arrays.items()}


def pinned(arrays: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """A batch's numpy arrays -> tensors in page-locked host memory, from
    which ``to_device(..., non_blocking=True)`` queues the copy to the card
    without synchronising the stream (a copy from pageable memory waits
    for the work queued before it).  Needs CUDA."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
            for k, v in arrays.items()}


def make_predict_step(model) -> Callable[..., Tuple[torch.Tensor, torch.Tensor]]:
    """Inference step: ``(batch, norm) -> (event_probs [B, Kev], prong_probs
    [B, P, Kpr])``, softmax over the logits.  Puts ``model`` in eval mode.

    In split mode the event scores are the 4-way current head's softmax (the
    generation head is a training-time auxiliary).
    """
    num_event = model.cfg.num_event_classes
    model.eval()

    @torch.inference_mode()
    def step(batch, norm):
        event_logits, prong_logits = model(batch, norm)
        return (
            torch.softmax(event_logits[:, :num_event], dim=-1),
            torch.softmax(prong_logits, dim=-1),
        )

    return step


def predict_split(
    model,
    dataset,
    norm: Mapping[str, np.ndarray],
    batch_size: int,
    device,
    coo_granularity: int = 8192,
    fixed_shape: bool = False,
    prong_bucket_multipliers: Optional[Sequence[int]] = None,
    fold_eval_bn: bool = False,
) -> Dict[str, np.ndarray]:
    """Batched inference over ``dataset`` (an ``EventDataset``, or anything
    with what ``Batcher.build_batch`` reads).

    Returns event probabilities/targets for every event and prong
    probabilities/targets for every *real* prong, plus each prong's owning
    event index.  The last batch is wrap-padded by the batcher and trimmed.
    ``prong_bucket_multipliers`` lays batches out as the ``Trainer``'s
    batchers do.  ``fold_eval_bn`` (the options' eval-time
    BatchNorm folding) is not ported and raises.
    """
    if fold_eval_bn:
        raise NotImplementedError(
            "fold_eval_bn is not ported yet (ROADMAP.md §1 item 17, ops/fold.py); "
            "turn the option off")
    batcher = Batcher(
        dataset,
        batch_size=batch_size,
        prong_bucket_multipliers=prong_bucket_multipliers,
        coo_granularity=coo_granularity,
        drop_last=False,
        fixed_shape=fixed_shape,
    )
    step = make_predict_step(model)
    norm_t = to_device(norm, device)
    ev_probs, ev_targets = [], []
    pr_probs, pr_targets, pr_event = [], [], []
    seen = 0
    for batch in batcher.prefetch_epoch(0):
        probs_e, probs_p = step(to_device(batch, device), norm_t)
        probs_e, probs_p = probs_e.cpu().numpy(), probs_p.cpu().numpy()
        take = min(batch_size, len(dataset) - seen)
        mask = batch["prong_targets"][:take] >= 0
        ev_probs.append(probs_e[:take])
        targets = batch["event_targets"][:take]
        if model.cfg.num_generation_classes:
            # scores are the 4-way current head; remap targets to match
            targets = split_current_targets(targets)
        ev_targets.append(targets)
        pr_probs.append(probs_p[:take][mask])
        pr_targets.append(batch["prong_targets"][:take][mask])
        pr_event.append(np.nonzero(mask)[0] + seen)
        seen += take

    return {
        "event_probabilities": np.concatenate(ev_probs),
        "event_targets": np.concatenate(ev_targets),
        "prong_probabilities": np.concatenate(pr_probs),
        "prong_targets": np.concatenate(pr_targets),
        "prong_event_index": np.concatenate(pr_event),
    }
