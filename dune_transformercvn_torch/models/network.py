"""TransformerCVN: the full event + prong classification network.

Port of ``dune_transformercvn_tpu/models/network.py``: two pixel embedders
(event and packed prong images) of the family ``ModelConfig.embedder``
names, the prong feature embedding, learned type position embeddings, the
shared combined LinearBlock, the masked transformer encoder and the two
heads.  Every family but coo runs on images densified from the hit banks
(kernel K1 on the card); the coo family's DenseNet runs its stem sparsely on
the banks (kernel K2).  The sdxl family can run its embedders over the bank
in chunks (:func:`apply_embedder`).

Module names follow the reference ``state_dict``: everything that builds the
tokens sits under ``prong_embedding.`` (``event_pixel_embedding``,
``prong_pixel_embedding``, ``feature_embedding``, ``combined_embedding``, the
two position vectors), then ``encoder.encoder.layers.{i}``, ``event_decoder``
and ``prong_decoder``.  Parameters are float32 and are cast to
``cfg.compute_dtype`` where they are used; no autocast.  Training mode is
torch's ``module.train()``: batch statistics, dropout and pixel noise.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from functools import partial
from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import CheckpointPolicy

from ..ops.masked import remat
from ..ops.scatter import densify_images, pack_rows, pad_rows
from ..parallel.mesh import whole
from .blocks import FeatureEmbedding, LinearBlock, lecun_normal_, make_divisible
from .coo_densenet import CooStemDenseNet
from .densenet import DenseNet, SpaceToDepthStem
from .encoder import MultiHeadAttention, TransformerEncoder
from .heads import EventDecoder, ProngDecoder
from .mobilenet import DEFAULT_STRUCTURE, MobileNetV2
from .resnet import ResNetStack
from .sdxl import SDXLEncoder
from .sparse_convnext import SparseConvNeXt
from .sparse_densenet import SparseDenseNet
from .sparse_fcnn import SparseFCNN


@dataclass(frozen=True)
class ModelConfig:
    # architecture
    hidden_dim: int = 128
    initial_feature_dim: int = 32
    initial_pixel_dim: int = 16
    feature_embedding_dim: int = 8
    pixel_embedding_dim: int = 512
    position_embedding_dim: int = 16
    num_embedding_layers: int = 100
    num_encoder_layers: int = 5
    num_prong_decoder_layers: int = 4
    num_attention_heads: int = 8
    transformer_activation: str = "gelu"
    transformer_norm_first: bool = False
    linear_prelu_activation: bool = True
    linear_batch_norm: bool = True
    disable_smart_features: bool = False
    one_hot_pixels: bool = False
    log_pixels: bool = False
    densenet_structure: Tuple[int, ...] = (6, 12, 24, 16)
    densenet_growth_rate: int = 16
    densenet_batch_norm_size: int = 4
    mobilenet_structure: Optional[Tuple[Tuple[int, ...], ...]] = None
    dropout: float = 0.0
    pixel_noise_std: float = 0.01
    # data dims
    features_dim: int = 6
    extra_dim: int = 4
    pixel_channels: int = 3
    image_height: int = 400
    image_width: int = 280
    max_prongs: int = 20
    num_event_classes: int = 4
    num_prong_classes: int = 8
    # split-event-targets variant: generation classes appended to the event head
    num_generation_classes: int = 0
    # ClassifierProng variant: decode the event class from a learned token
    # placed ahead of the event-image token
    learned_classifier_token: bool = False
    # embedder family: 'dense' | 'coo' | 'sdxl' | 'sparse' | 'mobilenet'
    # | 'resnet' | 'convnext' | 'fcnn'
    embedder: str = "dense"
    compute_dtype: str = "bfloat16"
    # dense family: the 7x7/2 stem as a 4x4/1 conv over 2x2 space-to-depth
    # input, which kernel K1 emits directly
    stem_space_to_depth: bool = False
    # transitions pool before their 1x1 conv
    transition_pool_first: bool = False
    # reference quirk: prongs reuse the *event* position embedding unless set
    fix_prong_position_embedding: bool = False
    # recompute in the backward: each DenseNet bottleneck, each whole embedder
    remat_cnn: bool = False
    remat_embedder: bool = False
    # sdxl only: run the embedders over the bank in sequential chunks of
    # this many rows, each recomputed in the backward (0 = off); and within
    # a chunk keep the conv outputs of at most this many pixels (0 = none)
    embedder_chunk: int = 0
    embedder_chunk_save_spatial: int = 0

    @classmethod
    def from_options(
        cls,
        options,
        features_dim: int,
        extra_dim: int,
        pixel_channels: int,
        num_event_classes: int,
        num_prong_classes: int,
        image_shape: Tuple[int, int] = (400, 280),
        embedder: str = "dense",
    ) -> "ModelConfig":
        split = bool(getattr(options, "split_event_targets", False))
        chunk = int(getattr(options, "embedder_chunk", 0) or 0)
        if chunk and embedder != "sdxl":
            raise ValueError(
                "embedder_chunk is only valid with the sdxl embedder: its "
                "GroupNorm is per-sample so chunked == full-bank exactly; "
                "the BatchNorm families compute bank-wide statistics "
                f"(got embedder={embedder!r})"
            )
        if split and (
            getattr(options, "event_current_targets", False)
            or num_event_classes > 10
        ):
            raise ValueError(
                "split_event_targets derives current/generation targets from "
                "the 10-class detailed event target; disable "
                "event_current_targets (got a "
                f"{num_event_classes}-class dataset)"
            )
        return cls(
            hidden_dim=options.hidden_dim,
            initial_feature_dim=options.initial_feature_dim,
            initial_pixel_dim=options.initial_pixel_dim,
            feature_embedding_dim=make_divisible(options.feature_embedding_dim, 8),
            pixel_embedding_dim=make_divisible(options.pixel_embedding_dim, 8),
            position_embedding_dim=make_divisible(options.position_embedding_dim, 8),
            num_embedding_layers=options.num_embedding_layers,
            num_encoder_layers=options.num_encoder_layers,
            num_prong_decoder_layers=options.num_prong_decoder_layers,
            num_attention_heads=options.num_attention_heads,
            transformer_activation=options.transformer_activation,
            transformer_norm_first=options.transformer_norm_first,
            linear_prelu_activation=options.linear_prelu_activation,
            linear_batch_norm=options.linear_batch_norm,
            disable_smart_features=options.disable_smart_features,
            one_hot_pixels=options.one_hot_pixels,
            log_pixels=options.log_pixels,
            densenet_structure=tuple(options.densenet_structure),
            densenet_growth_rate=options.densenet_growth_rate,
            densenet_batch_norm_size=options.densenet_batch_norm_size,
            mobilenet_structure=(
                tuple(tuple(row) for row in options.mobilenet_structure)
                if options.mobilenet_structure else None
            ),
            dropout=options.dropout,
            pixel_noise_std=options.pixel_noise_std,
            features_dim=features_dim,
            extra_dim=extra_dim,
            pixel_channels=pixel_channels,
            image_height=image_shape[0],
            image_width=image_shape[1],
            num_event_classes=4 if split else num_event_classes,
            num_prong_classes=num_prong_classes,
            num_generation_classes=4 if split else 0,
            learned_classifier_token=getattr(options, "learned_classifier_token", False),
            embedder=embedder,
            compute_dtype=options.compute_dtype,
            stem_space_to_depth=bool(getattr(options, "stem_space_to_depth", False)),
            transition_pool_first=bool(getattr(options, "transition_pool_first", False)),
            remat_cnn=bool(options.remat_cnn),
            remat_embedder=bool(getattr(options, "remat_embedder", False)),
            embedder_chunk=chunk,
            embedder_chunk_save_spatial=int(
                getattr(options, "embedder_chunk_save_spatial", 0) or 0),
        )

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    @property
    def cnn_input_channels(self) -> int:
        return self.pixel_channels * 256 if self.one_hot_pixels else self.pixel_channels


def _densenet(cfg: ModelConfig, **kwargs):
    return dict(initial_features=cfg.initial_pixel_dim,
                growth_rate=cfg.densenet_growth_rate,
                batch_norm_size=cfg.densenet_batch_norm_size,
                block_config=cfg.densenet_structure, dropout=cfg.dropout,
                remat=cfg.remat_cnn, **kwargs)


# embedder family -> (module class, its constructor's keywords from the
# config); every class takes (in_channels, output_dim, ..., compute_dtype)
_EMBEDDERS = {
    "dense": (DenseNet, lambda cfg: _densenet(
        cfg, stem_space_to_depth=cfg.stem_space_to_depth,
        transition_pool_first=cfg.transition_pool_first)),
    "coo": (CooStemDenseNet, lambda cfg: _densenet(
        cfg, image_height=cfg.image_height, image_width=cfg.image_width,
        transition_pool_first=cfg.transition_pool_first)),
    "sdxl": (SDXLEncoder, lambda cfg: dict(
        init_block_dim=cfg.initial_pixel_dim,
        image_shape=(cfg.image_height, cfg.image_width))),
    "sparse": (SparseDenseNet, _densenet),
    "mobilenet": (MobileNetV2, lambda cfg: dict(
        initial_features=cfg.initial_pixel_dim,
        structure=cfg.mobilenet_structure or DEFAULT_STRUCTURE,
        input_shape=(cfg.image_height, cfg.image_width), dropout=cfg.dropout)),
    "resnet": (ResNetStack, lambda cfg: dict(
        initial_features=cfg.initial_pixel_dim, dropout=cfg.dropout)),
    "convnext": (SparseConvNeXt, lambda cfg: dict(
        drop_path_rate=cfg.dropout, dropout=cfg.dropout)),
    "fcnn": (SparseFCNN, lambda cfg: dict(
        initial_features=cfg.initial_pixel_dim, dropout=cfg.dropout)),
}


def create_pixel_embedder(cfg: ModelConfig, output_dim: int) -> nn.Module:
    """The configured embedder family, mapping NHWC images ``[N, H, W, C]``
    (the coo family: a hit bank) and a slot mask to ``[N, output_dim]``."""
    try:
        family, kwargs = _EMBEDDERS[cfg.embedder]
    except KeyError:
        raise ValueError(f"unknown embedder family: {cfg.embedder}") from None
    return family(cfg.cnn_input_channels, output_dim, compute_dtype=cfg.dtype,
                  **kwargs(cfg))


def _save_small_convs(threshold: int, ctx, op, *args, **kwargs):
    """Selective-checkpoint policy: keep each convolution output of at most
    ``threshold`` pixels, recompute everything else.  The policy sees the
    op's inputs, so the output extent comes from the input extent, kernel,
    stride, padding and dilation.  (JAX tags the resnets', shortcuts' and
    downsamples' outputs by name; this keeps ``conv_out``'s 1x1 output too,
    which changes what is stored, not the numbers.)"""
    if op is torch.ops.aten.convolution.default:
        x, weight, _, stride, padding, dilation = args[:6]
        pixels = 1
        for i in range(2):
            k = dilation[i] * (weight.shape[2 + i] - 1) + 1
            pixels *= (x.shape[2 + i] + 2 * padding[i] - k) // stride[i] + 1
        if pixels <= threshold:
            return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def apply_embedder(cnn: nn.Module, images, mask, chunk: int = 0, save_spatial: int = 0):
    """``cnn(images, mask)``, or over the bank in sequential ``chunk``-row
    slices (``cfg.embedder_chunk``), each under :func:`..ops.masked.remat`:
    only one chunk's activations are live at a time, in the forward and in
    the backward's recompute.  The parameters are the same either way, and
    since sdxl's GroupNorm is per sample, so is the output.

    A bank no larger than ``chunk`` runs as one rematted slice; a larger
    bank that ``chunk`` does not divide runs as one full-bank call, with a
    warning.  A coo hit bank (a tuple) is never chunked.  ``save_spatial``
    > 0 keeps the conv outputs of at most that many pixels for the backward
    (:func:`_save_small_convs`) and recomputes the rest.
    """
    if chunk <= 0 or isinstance(images, tuple):
        return cnn(images, mask)
    n = images.shape[0]
    chunk = min(chunk, n)
    if n % chunk != 0:
        warnings.warn(
            f"embedder_chunk={chunk} does not divide bank size {n}; "
            f"falling back to ONE full-bank call — expect the OOM "
            f"chunking was meant to avoid. Pick a chunk dividing {n}.",
            stacklevel=2,
        )
        return cnn(images, mask)
    return torch.cat([
        _OwnGradient.apply(_chunk_step(
            cnn, images[i:i + chunk], None if mask is None else mask[i:i + chunk],
            save_spatial))
        for i in range(0, n, chunk)])


class _OwnGradient(torch.autograd.Function):
    """The identity, whose backward hands on a copy of the gradient: each
    chunk's cotangent is a tensor of its own rather than a slice of the
    bank's (``cat``'s backward), so the compiled chunk region traces its
    backward once, not once a slice offset."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad.clone()


@torch.compiler.nested_compile_region
def _chunk_step(cnn, images, mask, save_spatial: int):
    """One chunk of :func:`apply_embedder`: ``cnn`` under remat.  Compiled,
    every chunk of a bank is one call of a region traced once (JAX's
    ``nn.scan`` body), not a copy of it a chunk."""
    policy = partial(_save_small_convs, save_spatial) if save_spatial > 0 else None
    return remat(cnn, images, mask, policy=policy)


class ProngEmbedding(nn.Module):
    """Holder of the token-building modules under the reference's
    ``prong_embedding.`` prefix; :class:`TransformerCVN` drives them."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        dt = cfg.dtype
        event_pixel_dim = cfg.pixel_embedding_dim + cfg.feature_embedding_dim
        self.event_pixel_embedding = create_pixel_embedder(cfg, event_pixel_dim)
        self.prong_pixel_embedding = create_pixel_embedder(cfg, cfg.pixel_embedding_dim)
        self.feature_embedding = FeatureEmbedding(
            cfg.features_dim + cfg.extra_dim,
            output_dim=cfg.feature_embedding_dim,
            initial_dim=cfg.initial_feature_dim,
            max_layers=cfg.num_embedding_layers,
            disabled=cfg.disable_smart_features,
            batch_norm=cfg.linear_batch_norm,
            prelu=cfg.linear_prelu_activation,
            dropout=cfg.dropout,
            compute_dtype=dt,
        )
        self.event_position_embedding = nn.Parameter(
            torch.empty(1, cfg.position_embedding_dim))
        self.prong_position_embedding = nn.Parameter(
            torch.empty(1, cfg.position_embedding_dim))
        self.combined_embedding = LinearBlock(
            event_pixel_dim + cfg.position_embedding_dim,
            cfg.hidden_dim,
            batch_norm=cfg.linear_batch_norm,
            prelu=cfg.linear_prelu_activation,
            dropout=cfg.dropout,
            compute_dtype=dt,
        )


class TransformerCVN(nn.Module):
    """Full network, of any embedder family.

    Weights are drawn from ``generator`` (flax's initialisers: LeCun-normal
    kernels, zero biases, unit-normal position vectors), so a seed fixes them.
    """

    def __init__(self, cfg: ModelConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        dt = cfg.dtype
        self.prong_embedding = ProngEmbedding(cfg)
        if cfg.learned_classifier_token:
            self.classifier_embedding = nn.Parameter(torch.empty(1, 1, cfg.hidden_dim))
        self.encoder = TransformerEncoder(
            cfg.hidden_dim, cfg.num_attention_heads, cfg.num_encoder_layers,
            dropout=cfg.dropout, activation=cfg.transformer_activation,
            norm_first=cfg.transformer_norm_first, compute_dtype=dt,
        )
        self.event_decoder = EventDecoder(
            cfg.hidden_dim, cfg.num_event_classes + cfg.num_generation_classes, dt)
        self.prong_decoder = ProngDecoder(
            num_classes=cfg.num_prong_classes,
            hidden_dim=cfg.hidden_dim,
            num_layers=cfg.num_prong_decoder_layers,
            batch_norm=cfg.linear_batch_norm,
            prelu=cfg.linear_prelu_activation,
            dropout=cfg.dropout,
            compute_dtype=dt,
        )
        init_parameters(self, generator)

    def preprocess_values(self, values: torch.Tensor,
                          generator: Optional[torch.Generator] = None):
        """One-hot(256) per view, or log1p / divide-by-255 plus train-time
        multiplicative Gaussian noise; cast to the compute dtype."""
        cfg = self.cfg
        if cfg.one_hot_pixels:
            n, c = values.shape
            levels = torch.arange(256, device=values.device)
            # JAX's one_hot: values outside 0..255 give an all-zero row
            one_hot = values.long().unsqueeze(-1) == levels
            return one_hot.to(cfg.dtype).reshape(n, 256 * c)
        values = torch.log1p(values) if cfg.log_pixels else values / 255.0
        if self.training and cfg.pixel_noise_std > 0:
            noise = torch.randn(values.shape, generator=generator,
                                device=values.device, dtype=torch.float32)
            values = values * (1.0 + noise * cfg.pixel_noise_std)
        return values.to(cfg.dtype)

    def forward(self, batch: Dict[str, torch.Tensor], norm: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None):
        """Forward over one batch of the :class:`..data.Batcher` (as
        tensors).  ``norm``: 'mean', 'std', 'extra_mean', 'extra_std'.
        Returns float32 ``(event_logits [B, Kev], prong_logits [B, P, Kpr])``.

        The coo family feeds the hit banks straight to its sparse stem
        (kernel K2 on the card); every other family densifies them first
        (kernel K1 on the card).
        """
        cfg = self.cfg
        H, W = cfg.image_height, cfg.image_width
        # the s2d stem takes images that kernel K1 emits in s2d layout
        s2d = (cfg.embedder == "dense" and cfg.stem_space_to_depth
               and H % 2 == 0 and W % 2 == 0)
        banks = []
        for key, n in (("event", batch["features"].shape[0]),
                       ("prong", batch["slot_batch"].shape[0])):
            xy, owner, starts = (batch[f"{key}_xy"], batch[f"{key}_owner"],
                                 batch.get(f"{key}_starts"))
            values = self.preprocess_values(batch[f"{key}_vals"], generator)
            if cfg.embedder == "coo":
                banks.append((xy, values, owner, n, starts))
            else:
                banks.append(densify_images(xy, values, owner, n, H, W, starts=starts,
                                            space_to_depth=s2d))
        event_images, prong_images = banks
        event_logits, prong_logits, _, _ = self.forward_from_images(
            event_images, prong_images,
            batch["features"], batch["extra"], batch["prong_mask"],
            batch["slot_batch"], batch["slot_pos"], batch["slot_mask"], norm,
        )
        return event_logits, prong_logits

    def forward_from_images(
        self,
        event_images,   # [B, H, W, C] preprocessed NHWC (or s2d; coo: a hit bank)
        prong_images,   # [P, H, W, C] preprocessed NHWC (packed slots; coo: a hit bank)
        features,       # [B, max_prongs, F]
        extra,          # [B, E]
        prong_mask,     # [B, max_prongs] bool
        slot_batch,     # [P]
        slot_pos,       # [P]
        slot_mask,      # [P] bool
        norm,
    ):
        """Image-level forward.  Returns float32 ``(event_logits,
        prong_logits, event_hidden [B, D], prong_hidden [B, max_prongs, D])``.
        """
        cfg = self.cfg
        dt = cfg.dtype
        pe = self.prong_embedding
        B = features.shape[0]
        P = slot_batch.shape[0]
        slot_mask = slot_mask.bool()
        prong_mask = prong_mask.bool()

        # remat_embedder: only each embedder's inputs and output are kept
        # for the backward, which recomputes the CNN (its chunk loop too)
        def embed(cnn, images, mask):
            run = partial(apply_embedder, cnn, chunk=cfg.embedder_chunk,
                          save_spatial=cfg.embedder_chunk_save_spatial)
            return remat(cnn, images, mask, call=run) if cfg.remat_embedder else run(
                images, mask)

        event_pixel_emb = embed(pe.event_pixel_embedding, event_images, None)
        prong_pixel_emb = embed(pe.prong_pixel_embedding, prong_images, slot_mask)

        packed_features = pack_rows(features, slot_batch, slot_pos)
        packed_features = (packed_features - norm["mean"]) / norm["std"]
        packed_extra = extra[slot_batch.long().clamp(0, B - 1)]
        packed_extra = (packed_extra - norm["extra_mean"]) / norm["extra_std"]
        feature_emb = pe.feature_embedding(
            packed_features.to(dt), packed_extra.to(dt), slot_mask)

        # reference quirk kept by default: prongs reuse the event vector
        event_position = whole(pe.event_position_embedding)
        prong_position = (whole(pe.prong_position_embedding)
                          if cfg.fix_prong_position_embedding else event_position)
        event_tokens = torch.cat(
            [event_pixel_emb, event_position.expand(B, -1).to(dt)], 1)
        prong_tokens = torch.cat(
            [feature_emb, prong_pixel_emb, prong_position.expand(P, -1).to(dt)], 1)

        # shared combined embedding over [event rows; packed prong rows]
        combined = torch.cat([event_tokens, prong_tokens], 0)
        combined_mask = torch.cat(
            [torch.ones(B, dtype=torch.bool, device=slot_mask.device), slot_mask])
        combined = pe.combined_embedding(combined, combined_mask)

        event_hidden = combined[:B]
        prong_hidden = pad_rows(combined[B:], slot_batch, slot_pos, B, cfg.max_prongs)

        sequence = torch.cat([event_hidden[:, None, :], prong_hidden], 1)
        sequence_mask = torch.cat(
            [torch.ones((B, 1), dtype=torch.bool, device=prong_mask.device),
             prong_mask], 1)
        cls_offset = 1 if cfg.learned_classifier_token else 0
        if cfg.learned_classifier_token:
            token = whole(self.classifier_embedding).expand(B, 1, -1).to(dt)
            sequence = torch.cat([token, sequence], 1)
            sequence_mask = torch.cat([sequence_mask[:, :1], sequence_mask], 1)
        hidden = self.encoder(sequence, sequence_mask)

        event_logits = self.event_decoder(hidden[:, 0])
        prong_tokens_hidden = hidden[:, 1 + cls_offset:]
        prong_logits = self.prong_decoder(prong_tokens_hidden, prong_mask)
        return (
            event_logits.float(),
            prong_logits.float(),
            hidden[:, 0].float(),
            prong_tokens_hidden.float(),
        )


def init_parameters(model: nn.Module, generator: Optional[torch.Generator] = None):
    """Draw every randomly initialised weight of ``model`` from ``generator``
    with flax's default initialisers; biases start at zero.  BatchNorm,
    PReLU and LayerNorm keep their constant starts."""
    for module in model.modules():
        if isinstance(module, (nn.Linear, nn.Conv2d, SpaceToDepthStem)):
            w = module.weight
            lecun_normal_(w, w[0].numel(), generator)
            if module.bias is not None:
                nn.init.zeros_(module.bias)
        elif isinstance(module, MultiHeadAttention):
            # q, k, v each a [D, D] projection with fan-in D
            for w in module.in_proj_weight.chunk(3):
                lecun_normal_(w, w.shape[1], generator)
            nn.init.zeros_(module.in_proj_bias)
        elif isinstance(module, ProngEmbedding):
            for p in (module.event_position_embedding, module.prong_position_embedding):
                nn.init.normal_(p, 0.0, 1.0, generator=generator)
    if isinstance(model, TransformerCVN) and model.cfg.learned_classifier_token:
        nn.init.normal_(model.classifier_embedding, 0.0, 1.0, generator=generator)
