"""The optimizer: AdamW with the reference's decay rule, after global-norm
clipping, at the scheduled learning rate.

Port of ``dune_transformercvn_tpu/train/optimizer.py`` for AdamW, the
production optimizer (the option files' "AdamW", and the reference's
"apex_adam" alias).

* **Decay rule.**  Weight decay applies to every parameter whose JAX leaf
  is not named ``bias`` (the live reference excludes biases only).  So
  norm scales, PReLU alphas, position vectors and the coo stem's
  ``stem_bias``, whose leaf name is not ``bias``, are decayed.  The JAX
  names come from :func:`..from_jax.jax_leaf_names`; a rule on the port's
  own names would exempt the coo stem's ``conv0.bias``.
* **Clipping** is optax's ``clip_by_global_norm``: ``g / ||g|| * max`` when
  ``||g|| >= max``, with no epsilon (``torch.nn.utils.clip_grad_norm_`` adds
  one).
* **Update.**  ``torch.optim.AdamW`` (betas 0.9 / 0.999, eps 1e-8) computes
  optax's ``adamw``: ``p -= lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)``.
  optax updates every leaf, so a parameter that got no gradient gets a zero
  one here (its Adam moments stay zero, its decay still applies).
"""

from __future__ import annotations

from typing import Dict, List

import torch
from torch import nn

from ..from_jax import jax_leaf_names

# optax factories of the JAX package that the port does not run yet
_NOT_PORTED = {"adam", "sgd", "rmsprop", "adagrad", "lamb", "lars", "lion"}
_ALIASES = {"apex_adam": "adamw", "apex_lamb": "lamb", "apex_sgd": "sgd"}


def decay_mask(model: nn.Module) -> Dict[str, bool]:
    """Parameter name -> True where weight decay applies."""
    return {name: leaf != "bias" for name, leaf in jax_leaf_names(model).items()}


def create_optimizer(options, model: nn.Module) -> torch.optim.AdamW:
    """AdamW over ``model``'s parameters in two groups, decayed and not,
    with ``lr`` set to the base rate (the train step scales it by the
    schedule before every update)."""
    name = _ALIASES.get(options.optimizer.lower(), options.optimizer.lower())
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"optimizer {options.optimizer!r} is not ported yet (ROADMAP.md): "
            "the port runs AdamW")
    if name != "adamw":
        # the JAX package's fallback for a name it does not know
        print(f"Unable to load desired optimizer: {options.optimizer}. "
              "Using AdamW as a default.")
    mask = decay_mask(model)
    params = dict(model.named_parameters())
    groups = [
        {"params": [p for n, p in params.items() if mask[n]],
         "weight_decay": options.l2_penalty},
        {"params": [p for n, p in params.items() if not mask[n]],
         "weight_decay": 0.0},
    ]
    return torch.optim.AdamW(groups, lr=options.learning_rate, betas=(0.9, 0.999),
                             eps=1e-8)


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """``sqrt(sum of squares)`` over every gradient (float32 gradients), in
    a few multi-tensor launches rather than a few per parameter."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float,
                         norm: torch.Tensor) -> None:
    """optax's ``clip_by_global_norm`` in place, given the global ``norm``:
    ``g * (max_norm / norm)`` when ``norm >= max_norm``, else ``g`` (optax
    computes ``g / norm * max_norm``: the same to a float32 rounding)."""
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(grads, scale)
