"""Configuration of TransformerCVN: the port's own copy of the JAX
package's ``config.py`` (json only), kept field for field identical so an
option file loads to the same :class:`Options` in both packages.

Field names, defaults, and JSON-coercion semantics are kept compatible with the
reference configuration system (the reference's transformercvn/options.py:7-188)
so that the published option files (e.g. fdhd_beam_2018prod_2023_08_07.json) load
unchanged.  Option files store booleans as 0/1 in some cases, hence the explicit
int/bool coercion in :meth:`Options.update_options`.

Execution options beyond the reference's have safe defaults, so reference
option files need no edits.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Sequence


class Options:
    """Flat, typed hyperparameter namespace with JSON overload support."""

    def __init__(
        self,
        training_file: str = "",
        testing_file: str = "",
        validation_file: str = "",
    ):
        # =========================================================================
        # Network Architecture
        # =========================================================================

        # Width used by all hidden layers / the shared transformer.
        self.hidden_dim: int = 128

        # Width of the first embedding layer of the feature MLP.
        self.initial_feature_dim: int = 32
        # Stem width of the pixel CNNs.
        self.initial_pixel_dim: int = 16

        # Split of the combined token embedding.
        self.feature_embedding_dim: int = 8
        self.pixel_embedding_dim: int = 512
        self.position_embedding_dim: int = 16

        # Smallest layer width for decoder MLPs.
        self.final_decoder_dim: int = 16

        # Maximum number of doubling layers in the feature-embedding MLP.
        self.num_embedding_layers: int = 100

        # Depth of the central shared transformer.
        self.num_encoder_layers: int = 5

        # Depth of the classification decoders.
        self.num_decoder_layers: int = 100
        self.num_prong_decoder_layers: int = 4

        # Attention heads for all transformer layers.
        self.num_attention_heads: int = 8

        # 'relu' or 'gelu'.
        self.transformer_activation: str = "gelu"

        # Pre-norm (True) vs post-norm (False) transformer blocks.
        self.transformer_norm_first: bool = False

        # PReLU (True) vs ReLU (False) on linear / embedding blocks.
        self.linear_prelu_activation: bool = True

        # BatchNorm on linear / embedding blocks.
        self.linear_batch_norm: bool = True

        # Zero out the reconstructed-variable inputs (production default: True).
        self.disable_smart_features: bool = False

        # Normalize inputs with dataset mean/std.
        self.normalize_features: bool = True

        self.one_hot_pixels: bool = False
        self.log_pixels: bool = False

        self.mobilenet_structure: Optional[List[List[int]]] = None

        self.densenet_structure: List[int] = [6, 12, 24, 16]
        self.densenet_growth_rate: int = 16
        self.densenet_batch_norm_size: int = 4

        # =========================================================================
        # Dataset Options
        # =========================================================================

        self.training_file: str = training_file
        self.testing_file: str = testing_file
        self.validation_file: str = validation_file

        # Use only the first fraction of the data.
        self.dataset_limit: float = 1.0

        # Fraction of data used for training (rest: validation).
        self.train_validation_split: float = 0.95

        self.batch_size: int = 2048

        # Host-side data pipeline worker threads.
        self.num_dataloader_workers: int = 8

        # Load the full pixel banks into RAM at start.
        self.load_full_dataset: bool = False

        # Remap the 10 detailed event classes onto the basic 4 current classes.
        self.event_current_targets: bool = False

        # =========================================================================
        # Training Options
        # =========================================================================

        # Optimizer name: AdamW / Adam / SGD / Lamb (optax-backed).
        self.optimizer: str = "AdamW"

        self.learning_rate: float = 0.0001

        # Decoupled weight decay (masked off bias / LayerNorm scale params).
        self.l2_penalty: float = 0.015

        # Global gradient-norm clip; 0 disables.
        self.gradient_clip: float = 90.0

        self.dropout: float = 0.0

        self.epochs: int = 25

        # Warmup duration in (possibly fractional) epochs.
        self.learning_rate_warmup_epochs: float = 1.0

        # Cosine-annealing hard-restart cycle count; <1 uses linear decay.
        self.learning_rate_cycles: int = 1

        # Number of accelerator chips to use (data-parallel mesh size).
        self.num_gpu: int = 1

        self.event_prong_loss_proportion: float = 0.5

        # CB-loss beta; unused by the live focal loss (matches reference) but
        # consumed by the split-event-targets variant's class-balanced loss.
        self.loss_beta: float = 2.5

        # Focal-loss exponent; 0 means plain cross-entropy.
        self.loss_gamma: float = 0.0

        # Std of train-time multiplicative pixel noise.
        self.pixel_noise_std: float = 0.01

        # =========================================================================
        # Capability variants (legacy-informed; SURVEY §2.4)
        # =========================================================================

        # Dual event heads: 4-way interaction current + 4-way interaction
        # generation/mode derived from the 10-class detailed target, trained
        # with the class-balanced focal loss (neutrino_split_trainer.py:82-115,
        # split_dataset.py:10-23).  Requires event_current_targets = False.
        self.split_event_targets: bool = False

        # Weight of the generation loss relative to the current loss in split
        # mode (the reference split trainer reuses event_prong_loss_proportion
        # for this because it has no prongs; here prongs coexist).
        self.generation_loss_proportion: float = 0.5

        # Per-class sigmoid BCE event loss instead of softmax focal
        # (electron_prong_pixel_trainer.py:12-14).
        self.event_binary_loss: bool = False

        # Prepend a learned classifier token ahead of the event-image token
        # and decode the event class from it (ClassifierProng,
        # neutrino_combined_network.py:104-121).
        self.learned_classifier_token: bool = False

        # =========================================================================
        # Miscellaneous Options
        # =========================================================================

        self.verbose_output: bool = True

        self.usable_gpus: str = ""
        self.trial_time: str = ""
        self.trial_output_dir: str = "./test_output"

        # =========================================================================
        # Execution options of the JAX package (absent from reference option
        # files).  Carried with the same names and defaults so every option
        # file loads to the same Options in both packages; the port reads
        # compute_dtype, coo_bucket_granularity, embedder,
        # stem_space_to_depth, transition_pool_first, auc_bins and seed, and
        # leaves the others to the JAX package (ROADMAP.md).
        # =========================================================================

        # Compute dtype for the network ('bfloat16' or 'float32'); params stay fp32.
        self.compute_dtype: str = "bfloat16"

        # Packed-prong bucket sizes in average prongs-per-event; None = the
        # batcher's automatic ladder.
        self.prong_bucket_multipliers: Optional[List[int]] = None

        # COO hit-count buckets are rounded up to this granularity (per shard).
        self.coo_bucket_granularity: int = 8192

        # One static batch signature (dataset-derived upper-bound caps).
        self.static_batch_shapes: bool = False

        # Optimizer steps per device dispatch (JAX package: lax.scan over K
        # stacked batches).
        self.steps_per_dispatch: int = 1

        # Pixel-embedder family ('dense' | 'coo' | 'sdxl' | 'sparse' |
        # 'mobilenet' | 'resnet' | 'convnext' | 'fcnn').
        self.embedder: str = "dense"

        # Fold eval-time BatchNorm affines into adjacent conv weights on the
        # inference/export paths.
        self.fold_eval_bn: bool = False

        # Rematerialize CNN bottlenecks / whole pixel embedders in backward.
        self.remat_cnn: bool = False
        self.remat_embedder: bool = False

        # Run the pixel embedders over the image bank in chunks of this many
        # rows (SDXL family only); 0 = off.
        self.embedder_chunk: int = 0

        # Inside the embedder chunk body, save conv outputs whose spatial
        # extent is at most this value; 0 = save nothing.
        self.embedder_chunk_save_spatial: int = 0

        # Dense family: the 7x7/2 stem as a 4x4/1 conv over the 2x2
        # space-to-depth input (same parameters, same map).
        self.stem_space_to_depth: bool = False

        # Dense/coo families: transitions average-pool BEFORE the 1x1 conv
        # (both linear, so the map is the same with 4x fewer conv FLOPs).
        self.transition_pool_first: bool = False

        # Cross-replica synchronized batch-norm statistics.
        self.sync_batch_norm: bool = True

        # Tensor parallelism over a second "model" mesh axis; 1 = off.
        self.model_parallel: int = 1

        # Steps between validation runs / checkpoints (CLI -e overrides).
        self.eval_interval: int = 500

        # Checkpoints retained (best by val_epoch_AUC), plus 'last'.
        self.checkpoint_top_k: int = 5

        # Histogram bins for the streaming AUC estimator.
        self.auc_bins: int = 4096

        # Seed for params/data-order/noise RNG streams.
        self.seed: int = 0

    # -----------------------------------------------------------------------------

    def update_options(self, new_options: Dict[str, Any]) -> None:
        """Apply a JSON dict, coercing ints and bools like the reference loader."""
        integer_keys = {k for k, v in self.__dict__.items() if type(v) is int}
        boolean_keys = {k for k, v in self.__dict__.items() if type(v) is bool}
        for key, value in new_options.items():
            if key in boolean_keys:
                setattr(self, key, bool(value))
            elif key in integer_keys:
                setattr(self, key, int(value))
            else:
                setattr(self, key, value)

    @classmethod
    def load(cls, filepath: str) -> "Options":
        options = cls()
        with open(filepath, "r") as json_file:
            options.update_options(json.load(json_file))
        return options

    def to_dict(self) -> Dict[str, Any]:
        return dict(self.__dict__)

    def save(self, filepath: str) -> None:
        with open(filepath, "w") as json_file:
            json.dump(self.to_dict(), json_file, indent=4)

    def display(self) -> str:
        lines = ["=" * 70, "Options", "-" * 70]
        lines += [f"{key:32}: {val}" for key, val in sorted(vars(self).items())]
        lines.append("=" * 70)
        text = "\n".join(lines)
        print(text)
        return text

    def __repr__(self) -> str:  # pragma: no cover
        return f"Options({len(self.__dict__)} fields)"
