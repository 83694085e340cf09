"""Eval-time BatchNorm folding for the DenseNet-family pixel embedders.

Port of ``dune_transformercvn_tpu/ops/fold.py``.  At eval,
:class:`.masked.MaskedBatchNorm` is a per-channel affine of its input,
``y = a * x + d`` with ``a = weight / sqrt(running_var + eps)`` and
``d = bias - running_mean * a``.  Where a convolution feeds a BatchNorm
directly (the DenseNet stem ``features.conv0 -> features.norm0`` and each
bottleneck's ``bottleneck_block.conv1 -> output_block.norm2``), the affine
goes into the conv's own weights,

    W'[o] = W[o] * a[o]          b'[o] = b[o] * a[o] + d[o]

and the BatchNorm becomes the identity (weight 1, bias 0, running mean 0,
running variance ``1 - eps``, so ``1 / sqrt(var + eps) == 1``).

A transformation of values only, on a ``state_dict``, in float32: the module
tree, the names and the shapes stay, so a folded ``state_dict`` loads into
the same model, and the folded BatchNorms still run.  It is valid for eval
only (a train step would update the identity statistics).

Not folded, as in JAX: BN -> PReLU -> conv sites (the nonlinearity sits
between), the output block's bias-free Linear -> BN, every family that is
not DenseNet-like (sdxl, mobilenet, resnet, convnext, fcnn; the sparse
family's convs have no bias), and the coo family's stem, which the JAX
package runs outside ``nn.Conv``.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Mapping, Tuple, Union

import torch
from torch import nn

from . import quant
from .masked import MaskedBatchNorm

_EPS = MaskedBatchNorm.eps
_SCOPES = ("prong_embedding.event_pixel_embedding",
           "prong_embedding.prong_pixel_embedding")


def _pairs(sd: Mapping[str, torch.Tensor], scope: str, embedder: str) -> List[Tuple[str, str]]:
    """(conv, BN) module-name pairs inside one embedder.  A conv without a
    bias (the sparse family's) has nothing to absorb ``d`` into."""
    f = f"{scope}.features"
    pairs = []
    if embedder != "coo" and f"{f}.conv0.bias" in sd and f"{f}.norm0.running_mean" in sd:
        pairs.append((f"{f}.conv0", f"{f}.norm0"))
    i = 1
    while f"{f}.dense{i}.layers.0.bottleneck_block.conv1.weight" in sd:
        j = 0
        while f"{f}.dense{i}.layers.{j}.bottleneck_block.conv1.weight" in sd:
            layer = f"{f}.dense{i}.layers.{j}"
            if f"{layer}.bottleneck_block.conv1.bias" in sd:
                pairs.append((f"{layer}.bottleneck_block.conv1", f"{layer}.output_block.norm2"))
            j += 1
        i += 1
    return pairs


def _state_and_family(source: Union[nn.Module, Mapping[str, torch.Tensor]], embedder):
    if isinstance(source, nn.Module):
        return source.state_dict(), embedder or source.cfg.embedder
    return source, embedder or "dense"


def count_foldable(source: Union[nn.Module, Mapping[str, torch.Tensor]],
                   embedder: str = None) -> int:
    """Number of conv -> BN adjacencies :func:`fold_eval_batchnorm` folds, from
    the names alone.  ``source``: a ``TransformerCVN`` (its family read from
    its config) or its ``state_dict`` (``embedder``, default 'dense', says
    whether the stem is the coo family's)."""
    sd, embedder = _state_and_family(source, embedder)
    return sum(len(_pairs(sd, scope, embedder)) for scope in _SCOPES)


def fold_eval_batchnorm(state_dict: Mapping[str, torch.Tensor],
                        embedder: str = "dense") -> Tuple[Dict[str, torch.Tensor], int]:
    """Fold every conv -> BN adjacency of the DenseNet-family embedders.

    Returns ``(folded_state_dict, num_folds)``: a new dict in which the
    folded convs and BatchNorms are new float32 tensors on their original
    device and every other entry is the caller's tensor.  ``embedder`` is
    the model's family ('coo' leaves the stem alone)."""
    sd = dict(state_dict)
    folds = 0
    for scope in _SCOPES:
        for conv, bn in _pairs(sd, scope, embedder):
            var = sd[f"{bn}.running_var"].float()
            a = sd[f"{bn}.weight"].float() / torch.sqrt(var + _EPS)
            d = sd[f"{bn}.bias"].float() - sd[f"{bn}.running_mean"].float() * a
            weight = sd[f"{conv}.weight"].float()
            sd[f"{conv}.weight"] = weight * a.reshape((-1,) + (1,) * (weight.ndim - 1))
            sd[f"{conv}.bias"] = sd[f"{conv}.bias"].float() * a + d
            sd[f"{bn}.weight"] = torch.ones_like(a)
            sd[f"{bn}.bias"] = torch.zeros_like(d)
            sd[f"{bn}.running_mean"] = torch.zeros_like(d)
            sd[f"{bn}.running_var"] = torch.full_like(a, 1.0 - _EPS)
            folds += 1
    return sd, folds


def folded_copy(model: nn.Module) -> nn.Module:
    """``model`` itself when nothing folds, else a copy of it holding the
    folded values, for inference; the caller's module is left as it was.
    The copy shares each sync-BN process group with ``model``, and inside an
    int8 context (:func:`.quant.quantized_convs`) its convs are quantized as
    ``model``'s of the same names."""
    if count_foldable(model) == 0:
        return model
    groups = {id(m.process_group): m.process_group for m in model.modules()
              if isinstance(m, MaskedBatchNorm) and m.process_group is not None}
    clone = copy.deepcopy(model, groups)
    clone.load_state_dict(fold_eval_batchnorm(model.state_dict(), model.cfg.embedder)[0])
    quant.bind(clone)
    return clone
