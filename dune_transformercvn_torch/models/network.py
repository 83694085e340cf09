"""TransformerCVN: the full event + prong classification network.

Port of ``dune_transformercvn_tpu/models/network.py`` for the dense and coo
embedder families: two DenseNet pixel embedders (event and packed prong
images; the coo family's run their stem sparsely on the hit banks), the
prong feature embedding, learned type position embeddings, the shared
combined LinearBlock, the masked transformer encoder and the two heads.

Module names follow the reference ``state_dict``: everything that builds the
tokens sits under ``prong_embedding.`` (``event_pixel_embedding``,
``prong_pixel_embedding``, ``feature_embedding``, ``combined_embedding``, the
two position vectors), then ``encoder.encoder.layers.{i}``, ``event_decoder``
and ``prong_decoder``.  Parameters are float32 and are cast to
``cfg.compute_dtype`` where they are used; no autocast.  Training mode is
torch's ``module.train()``: batch statistics, dropout and pixel noise.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..ops.scatter import densify_images, pack_rows, pad_rows
from .blocks import FeatureEmbedding, LinearBlock, make_divisible
from .coo_densenet import CooStemDenseNet
from .densenet import DenseNet, SpaceToDepthStem
from .encoder import SelfAttention, TransformerEncoder
from .heads import EventDecoder, ProngDecoder


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
    # embedder family; the port runs 'dense' and 'coo'
    embedder: str = "dense"
    compute_dtype: str = "bfloat16"
    # dense family: the 7x7/2 stem as a 4x4/1 conv over 2x2 space-to-depth
    # input, which kernel K1 emits directly
    stem_space_to_depth: bool = False
    # transitions pool before their 1x1 conv
    transition_pool_first: bool = False
    # reference quirk: prongs reuse the *event* position embedding unless set
    fix_prong_position_embedding: bool = False

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
        )

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    @property
    def cnn_input_channels(self) -> int:
        return self.pixel_channels * 256 if self.one_hot_pixels else self.pixel_channels


class ProngEmbedding(nn.Module):
    """Holder of the token-building modules under the reference's
    ``prong_embedding.`` prefix; :class:`TransformerCVN` drives them."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        dt = cfg.dtype
        event_pixel_dim = cfg.pixel_embedding_dim + cfg.feature_embedding_dim
        cnn = dict(
            in_channels=cfg.cnn_input_channels,
            initial_features=cfg.initial_pixel_dim,
            growth_rate=cfg.densenet_growth_rate,
            batch_norm_size=cfg.densenet_batch_norm_size,
            block_config=cfg.densenet_structure,
            dropout=cfg.dropout,
            transition_pool_first=cfg.transition_pool_first,
            compute_dtype=dt,
        )
        if cfg.embedder == "coo":
            family = CooStemDenseNet
            cnn.update(image_height=cfg.image_height, image_width=cfg.image_width)
        else:
            family = DenseNet
            cnn.update(stem_space_to_depth=cfg.stem_space_to_depth)
        self.event_pixel_embedding = family(output_dim=event_pixel_dim, **cnn)
        self.prong_pixel_embedding = family(output_dim=cfg.pixel_embedding_dim, **cnn)
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
    """Full network, dense or coo embedder family.

    Weights are drawn from ``generator`` (flax's initialisers: LeCun-normal
    kernels, zero biases, unit-normal position vectors), so a seed fixes them.
    """

    def __init__(self, cfg: ModelConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.embedder not in ("dense", "coo"):
            raise NotImplementedError(
                f"embedder {cfg.embedder!r} is not ported yet (ROADMAP.md, "
                "open items 14-16); the port runs the dense and coo families")
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
        (kernel K2 on the card); the dense family densifies them first
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

        event_pixel_emb = pe.event_pixel_embedding(event_images, None)
        prong_pixel_emb = pe.prong_pixel_embedding(prong_images, slot_mask)

        packed_features = pack_rows(features, slot_batch, slot_pos)
        packed_features = (packed_features - norm["mean"]) / norm["std"]
        packed_extra = extra[slot_batch.long().clamp(0, B - 1)]
        packed_extra = (packed_extra - norm["extra_mean"]) / norm["extra_std"]
        feature_emb = pe.feature_embedding(
            packed_features.to(dt), packed_extra.to(dt), slot_mask)

        # reference quirk kept by default: prongs reuse the event vector
        prong_position = (pe.prong_position_embedding
                          if cfg.fix_prong_position_embedding
                          else pe.event_position_embedding)
        event_tokens = torch.cat(
            [event_pixel_emb, pe.event_position_embedding.expand(B, -1).to(dt)], 1)
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
            token = self.classifier_embedding.expand(B, 1, -1).to(dt)
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


def _lecun_normal_(tensor: torch.Tensor, fan_in: int,
                   generator: Optional[torch.Generator]):
    """flax's ``lecun_normal``: truncated normal (2 std) of variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(tensor, 0.0, 1.0, -2.0, 2.0, generator=generator)
        tensor.mul_(std)


def init_parameters(model: nn.Module, generator: Optional[torch.Generator] = None):
    """Draw every randomly initialised weight of ``model`` from ``generator``
    with flax's default initialisers; biases start at zero.  BatchNorm,
    PReLU and LayerNorm keep their constant starts."""
    for module in model.modules():
        if isinstance(module, (nn.Linear, nn.Conv2d, SpaceToDepthStem)):
            w = module.weight
            _lecun_normal_(w, w[0].numel(), generator)
            if module.bias is not None:
                nn.init.zeros_(module.bias)
        elif isinstance(module, SelfAttention):
            # q, k, v each a [D, D] projection with fan-in D
            for w in module.in_proj_weight.chunk(3):
                _lecun_normal_(w, w.shape[1], generator)
            nn.init.zeros_(module.in_proj_bias)
        elif isinstance(module, ProngEmbedding):
            for p in (module.event_position_embedding, module.prong_position_embedding):
                nn.init.normal_(p, 0.0, 1.0, generator=generator)
    if isinstance(model, TransformerCVN) and model.cfg.learned_classifier_token:
        nn.init.normal_(model.classifier_embedding, 0.0, 1.0, generator=generator)
