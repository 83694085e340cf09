"""Carry weights from the JAX package into the port.

``state_dict_from_jax`` turns a JAX ``{"params", "batch_stats"}`` tree of a
``TransformerCVN`` of any embedder family into the port's ``state_dict``.
For the dense and coo families it is the inverse of
``dune_transformercvn_tpu/torch_import.py::transplant_dense_network``, whose
keys are the reference network's (the coo stem's ``stem_kernel`` /
``stem_bias`` land in ``features.conv0`` as the dense stem's ``Conv_0``
does); the other families' embedders map by :class:`WeightMapper`'s method
of the family's name.  Conv kernels go HWIO -> OIHW, Dense kernels
``[in, out]`` -> ``[out, in]``, attention q/k/v ``[D, h, hd]`` kernels and
``[h, hd]`` biases pack into ``in_proj_weight [3D, D]`` / ``in_proj_bias``,
and ``out [h, hd, D]`` becomes ``out_proj`` (a cross-attention packs the same
way: queries from the targets, keys and values from the memory);
BatchNorm scale/bias/mean/var,
GroupNorm and LayerNorm scale/bias, PReLU alpha and ConvNeXt's layer scale
are copied.  :class:`WeightMapper` records which JAX leaves each tensor came
from.

:func:`jax_leaf_names` gives, for each parameter of a port model, the name
of the JAX leaf it is carried from (``kernel``, ``bias``, ``scale``,
``stem_bias``, ...); the optimizer's weight-decay rule reads it.
:func:`jax_leaf_splits` gives how many JAX leaves each parameter packs;
the optimizers' per-leaf trust ratios read it.  :func:`jax_channel_axes`
gives the shape of each parameter's JAX leaf and the port dimension that
holds the leaf's last axis; the tensor-parallel layout
(``parallel.state_shardings``) reads it.  ``WeightMapper.decoder_layer``
and ``WeightMapper.isab`` map the JAX package's ``DecoderLayer`` and
``InducedSetAttentionBlock``, which no network holds.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Sequence

import numpy as np
import torch
from torch import nn

from .models.coo_densenet import CooStemDenseNet
from .models.densenet import SpaceToDepthStem
from .models.encoder import MultiHeadAttention
from .models.heads import linear_block_layers
from .models.resnet import BLOCK_CONFIG as RESNET_BLOCK_CONFIG
from .models.sparse_convnext import HIDDEN_DEPTHS as CONVNEXT_DEPTHS
from .models.sparse_convnext import ConvNeXtBlock
from .ops.masked import MaskedBatchNorm, PReLU


def _join(sep: str, *parts: str) -> str:
    return sep.join(p for p in parts if p)


def _prefixes(name: str, path: str):
    """The port-name and JAX-path prefixes of a module ("" at the root)."""
    return (f"{name}." if name else ""), (f"{path}/" if path else "")


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
        """A conv, with its bias where the tree has one."""
        self.put(_join(".", name, "weight"),
                 self.take(_join("/", path, kernel)).transpose(3, 2, 0, 1))
        if self.has(_join("/", path, bias)):
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
        """A LayerNorm's or a GroupNorm's scale and bias."""
        self.put(_join(".", name, "weight"), self.take(_join("/", path, "scale")))
        self.put(_join(".", name, "bias"), self.take(_join("/", path, "bias")))

    def output_block(self, name, path, index=0):
        """Linear, BN, PReLU: ``Dense_0`` and the ``index``-th BN and PReLU."""
        self.linear(_join(".", name, "linear"), _join("/", path, "Dense_0"))
        self.batch_norm(_join(".", name, "norm"), _join("/", path, f"MaskedBatchNorm_{index}"))
        self.prelu(_join(".", name, "relu"), _join("/", path, f"PReLU_{index}"))

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
        self.output_block(_join(".", name, "output_block"), path, index=2)

    def embedder(self, name, path, cfg):
        """The pixel embedder of ``cfg.embedder``'s family."""
        if cfg.embedder in ("dense", "coo"):
            self.densenet(name, path, cfg.densenet_structure)
        elif cfg.embedder == "sparse":
            self.sparse_densenet(name, path, cfg.densenet_structure)
        else:
            getattr(self, cfg.embedder)(name, path)

    def resnet_block(self, name, path):
        """sdxl's resnet block: GroupNorm, conv, GroupNorm, conv, shortcut."""
        N, P = _prefixes(name, path)
        self.layer_norm(f"{N}norm1", f"{P}GroupNorm_0")
        self.conv(f"{N}conv1", f"{P}Conv_0")
        self.layer_norm(f"{N}norm2", f"{P}GroupNorm_1")
        self.conv(f"{N}conv2", f"{P}Conv_1")
        if self.has(f"{P}shortcut/kernel"):
            self.conv(f"{N}conv_shortcut", f"{P}shortcut")

    def sdxl(self, name, path):
        N, P = _prefixes(name, path)
        e = f"{N}encoder"
        self.conv(f"{e}.conv_in", f"{P}conv_in")
        i = 0
        while self.has(f"{P}DownEncoderBlock_{i}/ResnetBlock_0/Conv_0/kernel"):
            block, j = f"{P}DownEncoderBlock_{i}", 0
            while self.has(f"{block}/ResnetBlock_{j}/Conv_0/kernel"):
                self.resnet_block(f"{e}.down_blocks.{i}.resnets.{j}", f"{block}/ResnetBlock_{j}")
                j += 1
            if self.has(f"{block}/Conv_0/kernel"):
                self.conv(f"{e}.down_blocks.{i}.downsampler.conv", f"{block}/Conv_0")
            i += 1
        mid, attn = f"{e}.mid_block", f"{P}SpatialSelfAttention_0"
        self.resnet_block(f"{mid}.resnet1", f"{P}ResnetBlock_0")
        self.layer_norm(f"{mid}.attn.group_norm", f"{attn}/GroupNorm_0")
        for port, jax_name in (("to_q", "q"), ("to_k", "k"), ("to_v", "v"), ("to_out", "proj")):
            self.linear(f"{mid}.attn.{port}", f"{attn}/{jax_name}")
        self.resnet_block(f"{mid}.resnet2", f"{P}ResnetBlock_1")
        self.layer_norm(f"{e}.conv_norm_out", f"{P}GroupNorm_0")
        self.conv(f"{e}.conv_out", f"{P}conv_out")
        self.linear(f"{N}output_layer", f"{P}output_layer")

    def norm_prelu(self, norm, relu, path):
        """A ``SparseBatchNormPReLU``."""
        self.batch_norm(norm, f"{path}/MaskedBatchNorm_0")
        self.prelu(relu, f"{path}/PReLU_0")

    def sparse_densenet(self, name, path, block_config: Sequence[int]):
        N, P = _prefixes(name, path)
        f = f"{N}features"
        self.conv(f"{f}.conv0", f"{P}SparseConv_0")
        self.norm_prelu(f"{f}.norm0", f"{f}.relu0", f"{P}SparseBatchNormPReLU_0")
        k = 0
        for i, num_layers in enumerate(block_config):
            for j in range(num_layers):
                t, b = f"{f}.dense{i + 1}.layers.{j}", f"{P}SparseDenseLayer_{k}"
                self.norm_prelu(f"{t}.bottleneck_block.norm1", f"{t}.bottleneck_block.relu1",
                                f"{b}/SparseBatchNormPReLU_0")
                self.conv(f"{t}.bottleneck_block.conv1", f"{b}/SparseConv_0")
                self.norm_prelu(f"{t}.output_block.norm2", f"{t}.output_block.relu2",
                                f"{b}/SparseBatchNormPReLU_1")
                self.conv(f"{t}.output_block.conv2", f"{b}/SparseConv_1")
                k += 1
            if i != len(block_config) - 1:
                t, b = f"{f}.transition{i + 1}", f"{P}SparseTransition_{i}"
                self.norm_prelu(f"{t}.norm", f"{t}.relu", f"{b}/SparseBatchNormPReLU_0")
                self.conv(f"{t}.conv", f"{b}/SparseConv_0")
        self.norm_prelu(f"{f}.final_norm", f"{f}.final_relu", f"{P}SparseBatchNormPReLU_1")
        self.output_block(f"{N}output_block", path)

    def fcnn(self, name, path):
        N, P = _prefixes(name, path)
        self.conv(f"{N}stem.conv", f"{P}SparseConv_0")
        self.norm_prelu(f"{N}stem.norm", f"{N}stem.relu",
                        f"{P}SparseBatchNormPReLU_0")
        s = 0
        while self.has(f"{P}SparseConv_{s + 1}/kernel"):
            stage = f"{N}stages.{s}"
            self.conv(f"{stage}.conv", f"{P}SparseConv_{s + 1}")
            self.norm_prelu(f"{stage}.norm", f"{stage}.relu",
                            f"{P}SparseBatchNormPReLU_{s + 1}")
            s += 1
        self.output_block(f"{N}output_block", path)

    def convnext(self, name, path):
        N, P = _prefixes(name, path)
        self.conv(f"{N}stem.conv", f"{P}SparseConv_0")
        self.layer_norm(f"{N}stem.norm", f"{P}LayerNorm_0")
        k = 0
        for s, depth in enumerate(CONVNEXT_DEPTHS):
            stage = f"{N}stages.{s}"
            if s > 0:
                self.layer_norm(f"{stage}.downsample.norm", f"{P}LayerNorm_{s}")
                self.conv(f"{stage}.downsample.conv", f"{P}SparseConv_{s}")
            for b in range(depth):
                t, p = f"{stage}.blocks.{b}", f"{P}ConvNeXtBlock_{k}"
                self.conv(f"{t}.dwconv", f"{p}/SparseConv_0")
                self.layer_norm(f"{t}.norm", f"{p}/LayerNorm_0")
                self.linear(f"{t}.pwconv1", f"{p}/Dense_0")
                self.linear(f"{t}.pwconv2", f"{p}/Dense_1")
                self.put(f"{t}.gamma", self.take(f"{p}/layer_scale"))
                k += 1
        self.layer_norm(f"{N}head_norm", f"{P}LayerNorm_{len(CONVNEXT_DEPTHS)}")
        self.output_block(f"{N}output_block", path)

    def conv_block(self, name, path):
        """MobileNet's conv, BN (its SiLU and dropout have no parameters)."""
        N, P = _prefixes(name, path)
        self.conv(f"{N}conv", f"{P}Conv_0")
        self.batch_norm(f"{N}norm", f"{P}MaskedBatchNorm_0")

    def mobilenet(self, name, path):
        N, P = _prefixes(name, path)
        self.conv_block(f"{N}resnet.0", f"{P}ConvBlock_0")
        k = 0
        while self.has(f"{P}InvertedResidual_{k}/Conv_0/kernel"):
            pre, p = f"{N}resnet.{k + 1}.convolutions", f"{P}InvertedResidual_{k}"
            i = 0
            if self.has(f"{p}/ConvBlock_1/Conv_0/kernel"):     # an expand block
                self.conv_block(f"{pre}.0", f"{p}/ConvBlock_0")
                i = 1
            self.conv_block(f"{pre}.{i}", f"{p}/ConvBlock_{i}")
            self.linear(f"{pre}.{i + 1}.fc1", f"{p}/SqueezeExcite_0/Dense_0")
            self.linear(f"{pre}.{i + 1}.fc2", f"{p}/SqueezeExcite_0/Dense_1")
            self.conv(f"{pre}.{i + 2}", f"{p}/Conv_0")
            self.batch_norm(f"{pre}.{i + 3}", f"{p}/MaskedBatchNorm_0")
            k += 1
        self.conv_block(f"{N}resnet.{k + 1}", f"{P}ConvBlock_1")

    def resnet(self, name, path):
        N, P = _prefixes(name, path)
        self.conv(f"{N}stem.conv", f"{P}Conv_0")
        self.batch_norm(f"{N}stem.norm", f"{P}MaskedBatchNorm_0")
        self.prelu(f"{N}stem.relu", f"{P}PReLU_0")
        k = 0
        for layer, depth in enumerate(RESNET_BLOCK_CONFIG):
            for b in range(depth):
                pre, p = f"{N}blocks.{layer}.blocks.{b}", f"{P}ResNetBody_0/BasicBlock_{k}"
                self.conv(f"{pre}.blocks.0.conv", f"{p}/Conv_0")
                self.batch_norm(f"{pre}.blocks.0.bn", f"{p}/MaskedBatchNorm_0")
                self.prelu(f"{pre}.blocks.1", f"{p}/PReLU_0")
                self.conv(f"{pre}.blocks.2.conv", f"{p}/Conv_1")
                self.batch_norm(f"{pre}.blocks.2.bn", f"{p}/MaskedBatchNorm_1")
                if self.has(f"{p}/shortcut/kernel"):
                    self.conv(f"{pre}.shortcut.conv", f"{p}/shortcut")
                    self.batch_norm(f"{pre}.shortcut.bn", f"{p}/shortcut_norm")
                k += 1
        self.output_block(f"{N}output_block", path, index=1)

    def attention(self, name, path, hidden_dim: int):
        """A flax ``MultiHeadDotProductAttention``: its query, key and value
        kernels pack into ``in_proj_weight`` in that order (queries from the
        targets, keys and values from the memory in a cross-attention)."""
        D, qkv = hidden_dim, ("query", "key", "value")
        self.put(_join(".", name, "in_proj_weight"), np.concatenate(
            [self.take(_join("/", path, q, "kernel")).reshape(D, D).T for q in qkv]))
        self.put(_join(".", name, "in_proj_bias"), np.concatenate(
            [self.take(_join("/", path, q, "bias")).reshape(D) for q in qkv]))
        self.put(_join(".", name, "out_proj.weight"),
                 self.take(_join("/", path, "out/kernel")).reshape(D, D).T)
        self.put(_join(".", name, "out_proj.bias"), self.take(_join("/", path, "out/bias")))

    def encoder_layer(self, name, path, hidden_dim: int):
        self.attention(_join(".", name, "self_attn"),
                       _join("/", path, "MultiHeadDotProductAttention_0"), hidden_dim)
        self.linear(_join(".", name, "linear1"), _join("/", path, "Dense_0"))
        self.linear(_join(".", name, "linear2"), _join("/", path, "Dense_1"))
        self.layer_norm(_join(".", name, "norm1"), _join("/", path, "LayerNorm_0"))
        self.layer_norm(_join(".", name, "norm2"), _join("/", path, "LayerNorm_1"))

    def decoder_layer(self, name, path, hidden_dim: int):
        """JAX ``DecoderLayer``: the self-attention, the attention to the
        memory, the feed-forward and the three LayerNorms."""
        for port, index in (("self_attn", 0), ("multihead_attn", 1)):
            self.attention(_join(".", name, port),
                           _join("/", path, f"MultiHeadDotProductAttention_{index}"),
                           hidden_dim)
        self.linear(_join(".", name, "linear1"), _join("/", path, "Dense_0"))
        self.linear(_join(".", name, "linear2"), _join("/", path, "Dense_1"))
        for i in range(3):
            self.layer_norm(_join(".", name, f"norm{i + 1}"), _join("/", path, f"LayerNorm_{i}"))

    def isab(self, name, path, hidden_dim: int):
        """JAX ``InducedSetAttentionBlock``: the input projection where the
        tree has one, the inducing points and the two decoder layers."""
        if self.has(_join("/", path, "input_projection/kernel")):
            self.linear(_join(".", name, "input_projection"),
                        _join("/", path, "input_projection"))
        self.put(_join(".", name, "inducing_points"),
                 self.take(_join("/", path, "inducing_points")))
        for i in range(2):
            self.decoder_layer(_join(".", name, f"layers.{i}"),
                               _join("/", path, f"DecoderLayer_{i}"), hidden_dim)

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
    """The port's ``state_dict`` for a JAX ``TransformerCVN`` built from the
    same :class:`ModelConfig` fields.
    Raises if a JAX leaf is missing or left unused."""
    return map_jax_variables(variables, cfg).state_dict()


def map_jax_variables(variables: Mapping, cfg) -> WeightMapper:
    """The :class:`WeightMapper` with every leaf of a JAX ``TransformerCVN``
    moved into its ``sd`` (and ``sources`` filled)."""
    m = WeightMapper(variables)
    pe = "prong_embedding"
    m.embedder(f"{pe}.event_pixel_embedding", "event_pixel_embedding", cfg)
    m.embedder(f"{pe}.prong_pixel_embedding", "prong_pixel_embedding", cfg)
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
    ((MaskedBatchNorm, nn.LayerNorm, nn.GroupNorm), {"weight": "scale", "bias": "bias"}),
    ((PReLU,), {"weight": "alpha"}),
    ((ConvNeXtBlock,), {"gamma": "layer_scale"}),
    ((MultiHeadAttention,), {"in_proj_weight": "kernel", "in_proj_bias": "bias"}),
)


def jax_leaf_names(model: nn.Module) -> Dict[str, str]:
    """For each parameter of ``model``, the name of the JAX leaf it is
    carried from by :func:`state_dict_from_jax`: ``kernel`` / ``bias`` of a
    conv or dense layer, ``scale`` / ``bias`` of a norm, ``alpha`` of a
    PReLU, ``layer_scale`` of a ConvNeXt block, ``stem_kernel`` /
    ``stem_bias`` of the coo family's stem, and a position or classifier
    vector's own name."""
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


def jax_leaf_splits(model: nn.Module) -> Dict[str, int]:
    """For each parameter of ``model``, the number of JAX leaves stacked
    along its first axis: 3 for an attention's ``in_proj_weight`` and
    ``in_proj_bias`` (query, key, value), 1 for every other parameter."""
    splits = {}
    for mod_name, module in model.named_modules():
        for p_name, _ in module.named_parameters(recurse=False):
            packed = isinstance(module, MultiHeadAttention) and p_name.startswith("in_proj")
            splits[_join(".", mod_name, p_name)] = 3 if packed else 1
    return splits


def jax_channel_axes(model: nn.Module) -> Dict[str, tuple]:
    """For each parameter of ``model``, ``(shape, dim)``: the shape of the
    JAX leaf it is carried from by :func:`state_dict_from_jax` (one of the
    leaves it packs) and the port dimension holding that leaf's last,
    output-channel axis.  A conv kernel ``[kh, kw, in, out]`` and a dense
    kernel ``[in, out]`` sit in dim 0 of the port's OIHW / ``[out, in]``
    weight; the attention's q/k/v kernels ``[D, heads, head_dim]`` and
    biases ``[heads, head_dim]`` in dim 0 of the packed ``in_proj_*``; norm
    scales and biases, PReLU alphas and layer scales are 1-D; position,
    classifier and inducing vectors keep JAX's shape."""
    coo_stems = {f"{name}.features.conv0" for name, module in model.named_modules()
                 if isinstance(module, CooStemDenseNet)}
    axes = {}
    for mod_name, module in model.named_modules():
        for p_name, p in module.named_parameters(recurse=False):
            full, shape = _join(".", mod_name, p_name), tuple(p.shape)
            if isinstance(module, MultiHeadAttention) and p_name.startswith("in_proj"):
                hidden, heads = shape[0] // 3, module.num_heads
                leaf = (heads, hidden // heads)
                axes[full] = ((hidden,) + leaf if p_name == "in_proj_weight" else leaf, 0)
            elif (isinstance(module, (nn.Conv2d, SpaceToDepthStem)) or mod_name in coo_stems
                  ) and p_name == "weight":
                axes[full] = (shape[2:] + shape[1::-1], 0)
            elif isinstance(module, nn.Linear) and p_name == "weight":
                axes[full] = (shape[::-1], 0)
            else:
                axes[full] = (shape, len(shape) - 1)
    return axes


def load_jax_variables(model: torch.nn.Module, variables: Mapping) -> torch.nn.Module:
    """Fill every parameter and buffer of ``model`` from the JAX tree
    (strict both ways: no port tensor left unset, no JAX leaf unused)."""
    model.load_state_dict(state_dict_from_jax(variables, model.cfg), strict=True)
    return model
