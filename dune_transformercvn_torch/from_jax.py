"""Carry weights from the JAX package into the port.

``state_dict_from_jax`` is the inverse of
``dune_transformercvn_tpu/torch_import.py::transplant_dense_network``: it
turns a JAX ``{"params", "batch_stats"}`` tree of a dense- or coo-family
``TransformerCVN`` into the port's ``state_dict``, whose keys are the
reference network's (the coo stem's ``stem_kernel`` / ``stem_bias`` land in
``features.conv0`` as the dense stem's ``Conv_0`` does).  Conv kernels go
HWIO -> OIHW, Dense kernels ``[in, out]`` -> ``[out, in]``, attention q/k/v ``[D, h, hd]`` kernels and
``[h, hd]`` biases pack into ``in_proj_weight [3D, D]`` / ``in_proj_bias``,
and ``out [h, hd, D]`` becomes ``out_proj``; BatchNorm scale/bias/mean/var
and PReLU alpha are copied.  :class:`WeightMapper` does the same per module
and records which JAX leaves each tensor came from.

:func:`jax_leaf_names` gives, for each parameter of a port model, the name
of the JAX leaf it is carried from (``kernel``, ``bias``, ``scale``,
``stem_bias``, ...); the optimizer's weight-decay rule reads it.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Sequence

import numpy as np
import torch
from torch import nn

from .models.coo_densenet import CooStemDenseNet
from .models.densenet import SpaceToDepthStem
from .models.encoder import SelfAttention
from .models.heads import linear_block_layers
from .ops.masked import MaskedBatchNorm, PReLU


def _join(sep: str, *parts: str) -> str:
    return sep.join(p for p in parts if p)


class WeightMapper:
    """Moves the leaves of a JAX variable tree into a torch ``state_dict``,
    each leaf exactly once.  Methods take the port's module name (``.``
    separated, "" for the root) and the JAX module path (``/`` separated).
    ``sources`` maps each port tensor to the JAX leaf paths it was built
    from (``params/.../kernel``; three for a packed q/k/v projection)."""

    def __init__(self, variables: Mapping):
        self.leaves: Dict[str, np.ndarray] = {}
        for collection in ("params", "batch_stats"):
            self._flatten(variables.get(collection, {}), collection)
        self.sd: Dict[str, np.ndarray] = {}
        self.sources: Dict[str, List[str]] = {}
        self._taken: List[str] = []

    def _flatten(self, tree, prefix):
        for key, value in tree.items():
            path = f"{prefix}/{key}"
            if isinstance(value, Mapping):
                self._flatten(value, path)
            else:
                self.leaves[path] = np.asarray(value)

    def has(self, path: str) -> bool:
        return _join("/", "params", path) in self.leaves

    def take(self, path: str, collection: str = "params") -> np.ndarray:
        key = _join("/", collection, path)
        try:
            value = self.leaves.pop(key)
        except KeyError:
            raise KeyError(f"JAX variables lack {key} (or it was used twice)") from None
        self._taken.append(key)
        return value

    def put(self, name: str, value: np.ndarray):
        """Store ``value`` (made from the leaves taken since the last put)."""
        self.sd[name] = value
        self.sources[name], self._taken = self._taken, []

    def state_dict(self) -> Dict[str, torch.Tensor]:
        """The mapped tensors; raises if a JAX leaf was left unused."""
        if self.leaves:
            raise ValueError(f"JAX leaves with no place in the port: {sorted(self.leaves)}")
        return {k: torch.from_numpy(np.array(v, dtype=np.float32))
                for k, v in self.sd.items()}

    # ---- layers -----------------------------------------------------------

    def conv(self, name, path, kernel="kernel", bias="bias"):
        self.put(_join(".", name, "weight"),
                 self.take(_join("/", path, kernel)).transpose(3, 2, 0, 1))
        self.put(_join(".", name, "bias"), self.take(_join("/", path, bias)))

    def linear(self, name, path):
        self.put(_join(".", name, "weight"), self.take(_join("/", path, "kernel")).T)
        if self.has(_join("/", path, "bias")):
            self.put(_join(".", name, "bias"), self.take(_join("/", path, "bias")))

    def batch_norm(self, name, path):
        self.put(_join(".", name, "weight"), self.take(_join("/", path, "scale")))
        self.put(_join(".", name, "bias"), self.take(_join("/", path, "bias")))
        self.put(_join(".", name, "running_mean"),
                 self.take(_join("/", path, "mean"), "batch_stats"))
        self.put(_join(".", name, "running_var"),
                 self.take(_join("/", path, "var"), "batch_stats"))

    def prelu(self, name, path):
        self.put(_join(".", name, "weight"), self.take(_join("/", path, "alpha")))

    def layer_norm(self, name, path):
        self.put(_join(".", name, "weight"), self.take(_join("/", path, "scale")))
        self.put(_join(".", name, "bias"), self.take(_join("/", path, "bias")))

    # ---- modules ----------------------------------------------------------

    def linear_block(self, name, path):
        """``LinearBlock``: linear, then BN and PReLU where the tree has them."""
        self.linear(_join(".", name, "linear"), _join("/", path, "Dense_0"))
        if self.has(_join("/", path, "MaskedBatchNorm_0/scale")):
            self.batch_norm(_join(".", name, "norm"), _join("/", path, "MaskedBatchNorm_0"))
        if self.has(_join("/", path, "PReLU_0/alpha")):
            self.prelu(_join(".", name, "activation"), _join("/", path, "PReLU_0"))

    def feature_embedding(self, name, path):
        i = 0
        while self.has(_join("/", path, f"LinearBlock_{i}/Dense_0/kernel")):
            self.linear_block(_join(".", name, f"embedding.{i}"),
                              _join("/", path, f"LinearBlock_{i}"))
            i += 1

    def densenet(self, name, path, block_config: Sequence[int]):
        f = _join(".", name, "features")

        def sub(p):
            return _join("/", path, p)

        if self.has(sub("stem_kernel")):     # the coo family's sparse stem
            self.conv(f"{f}.conv0", path, "stem_kernel", "stem_bias")
        else:
            self.conv(f"{f}.conv0", sub("Conv_0"))
        self.batch_norm(f"{f}.norm0", sub("MaskedBatchNorm_0"))
        self.prelu(f"{f}.relu0", sub("PReLU_0"))
        k = 0
        for i, num_layers in enumerate(block_config):
            for j in range(num_layers):
                t, b = f"{f}.dense{i + 1}.layers.{j}", sub(f"Bottleneck_{k}")
                self.batch_norm(f"{t}.bottleneck_block.norm1", f"{b}/MaskedBatchNorm_0")
                self.prelu(f"{t}.bottleneck_block.relu1", f"{b}/PReLU_0")
                self.conv(f"{t}.bottleneck_block.conv1", f"{b}/Conv_0")
                self.batch_norm(f"{t}.output_block.norm2", f"{b}/MaskedBatchNorm_1")
                self.prelu(f"{t}.output_block.relu2", f"{b}/PReLU_1")
                self.conv(f"{t}.output_block.conv2", f"{b}/Conv_1")
                k += 1
            if i != len(block_config) - 1:
                t, b = f"{f}.transition{i + 1}", sub(f"Transition_{i}")
                self.batch_norm(f"{t}.norm", f"{b}/MaskedBatchNorm_0")
                self.prelu(f"{t}.relu", f"{b}/PReLU_0")
                self.conv(f"{t}.conv", f"{b}/Conv_0")
        self.batch_norm(f"{f}.final_norm", sub("MaskedBatchNorm_1"))
        self.prelu(f"{f}.final_relu", sub("PReLU_1"))
        out = _join(".", name, "output_block")
        self.linear(f"{out}.linear", sub("Dense_0"))
        self.batch_norm(f"{out}.norm", sub("MaskedBatchNorm_2"))
        self.prelu(f"{out}.relu", sub("PReLU_2"))

    def encoder_layer(self, name, path, hidden_dim: int):
        D = hidden_dim
        mha = _join("/", path, "MultiHeadDotProductAttention_0")
        qkv = ("query", "key", "value")
        attn = _join(".", name, "self_attn")
        self.put(f"{attn}.in_proj_weight", np.concatenate(
            [self.take(f"{mha}/{q}/kernel").reshape(D, D).T for q in qkv]))
        self.put(f"{attn}.in_proj_bias", np.concatenate(
            [self.take(f"{mha}/{q}/bias").reshape(D) for q in qkv]))
        self.put(f"{attn}.out_proj.weight", self.take(f"{mha}/out/kernel").reshape(D, D).T)
        self.put(f"{attn}.out_proj.bias", self.take(f"{mha}/out/bias"))
        self.linear(_join(".", name, "linear1"), _join("/", path, "Dense_0"))
        self.linear(_join(".", name, "linear2"), _join("/", path, "Dense_1"))
        self.layer_norm(_join(".", name, "norm1"), _join("/", path, "LayerNorm_0"))
        self.layer_norm(_join(".", name, "norm2"), _join("/", path, "LayerNorm_1"))

    def transformer_encoder(self, name, path, hidden_dim: int):
        i = 0
        while self.has(_join("/", path, f"EncoderLayer_{i}/Dense_0/kernel")):
            self.encoder_layer(_join(".", name, f"encoder.layers.{i}"),
                               _join("/", path, f"EncoderLayer_{i}"), hidden_dim)
            i += 1

    def prong_decoder(self, name, path, batch_norm: bool, dropout: float):
        """Block ``i`` fills ``hidden_layers`` from ``i * len(roles)``, in the
        order of :func:`..models.heads.linear_block_layers`."""
        roles = linear_block_layers(batch_norm, dropout)
        i = 0
        while self.has(_join("/", path, f"LinearBlock_{i}/Dense_0/kernel")):
            block = _join("/", path, f"LinearBlock_{i}")
            for r, role in enumerate(roles):
                layer = _join(".", name, f"hidden_layers.{i * len(roles) + r}")
                if role == "linear":
                    self.linear(layer, f"{block}/Dense_0")
                elif role == "norm":
                    self.batch_norm(layer, f"{block}/MaskedBatchNorm_0")
                elif role == "activation" and self.has(f"{block}/PReLU_0/alpha"):
                    self.prelu(layer, f"{block}/PReLU_0")
            i += 1
        self.linear(_join(".", name, "output_layer"), _join("/", path, "Dense_0"))


def state_dict_from_jax(variables: Mapping, cfg) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` for a JAX dense- or coo-family
    ``TransformerCVN`` built from the same :class:`ModelConfig` fields.
    Raises if a JAX leaf is missing or left unused."""
    return map_jax_variables(variables, cfg).state_dict()


def map_jax_variables(variables: Mapping, cfg) -> WeightMapper:
    """The :class:`WeightMapper` with every leaf of a JAX ``TransformerCVN``
    moved into its ``sd`` (and ``sources`` filled)."""
    m = WeightMapper(variables)
    pe = "prong_embedding"
    m.densenet(f"{pe}.event_pixel_embedding", "event_pixel_embedding",
               cfg.densenet_structure)
    m.densenet(f"{pe}.prong_pixel_embedding", "prong_pixel_embedding",
               cfg.densenet_structure)
    m.put(f"{pe}.event_position_embedding", m.take("event_position_embedding"))
    m.put(f"{pe}.prong_position_embedding", m.take("prong_position_embedding"))
    m.feature_embedding(f"{pe}.feature_embedding", "feature_embedding")
    m.linear_block(f"{pe}.combined_embedding", "combined_embedding")
    if cfg.learned_classifier_token:
        m.put("classifier_embedding", m.take("classifier_embedding"))
    m.transformer_encoder("encoder", "encoder", cfg.hidden_dim)
    m.linear("event_decoder.hidden_layer", "event_decoder/Dense_0")
    m.prong_decoder("prong_decoder", "prong_decoder", cfg.linear_batch_norm, cfg.dropout)
    return m


# JAX leaf name of each parameter, by the port module that holds it
_LEAF_NAMES = (
    ((nn.Conv2d, nn.Linear, SpaceToDepthStem), {"weight": "kernel", "bias": "bias"}),
    ((MaskedBatchNorm, nn.LayerNorm), {"weight": "scale", "bias": "bias"}),
    ((PReLU,), {"weight": "alpha"}),
    ((SelfAttention,), {"in_proj_weight": "kernel", "in_proj_bias": "bias"}),
)


def jax_leaf_names(model: nn.Module) -> Dict[str, str]:
    """For each parameter of ``model``, the name of the JAX leaf it is
    carried from by :func:`state_dict_from_jax`: ``kernel`` / ``bias`` of a
    conv or dense layer, ``scale`` / ``bias`` of a norm, ``alpha`` of a
    PReLU, ``stem_kernel`` / ``stem_bias`` of the coo family's stem, and a
    position or classifier vector's own name."""
    coo_stems = {f"{name}.features.conv0" for name, module in model.named_modules()
                 if isinstance(module, CooStemDenseNet)}
    names = {}
    for mod_name, module in model.named_modules():
        for p_name, _ in module.named_parameters(recurse=False):
            full = _join(".", mod_name, p_name)
            if mod_name in coo_stems:
                names[full] = {"weight": "stem_kernel", "bias": "stem_bias"}[p_name]
                continue
            table = next((t for types, t in _LEAF_NAMES if isinstance(module, types)), {})
            names[full] = table.get(p_name, p_name)
    return names


def load_jax_variables(model: torch.nn.Module, variables: Mapping) -> torch.nn.Module:
    """Fill every parameter and buffer of ``model`` from the JAX tree
    (strict both ways: no port tensor left unset, no JAX leaf unused)."""
    model.load_state_dict(state_dict_from_jax(variables, model.cfg), strict=True)
    return model
