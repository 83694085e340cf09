"""Models of the port: the full network and every embedder family of the
JAX package (dense, coo, sdxl, sparse, convnext, fcnn, mobilenet, resnet)."""

from .coo_densenet import CooStemDenseNet
from .encoder import DecoderLayer, InducedSetAttentionBlock
from .network import ModelConfig, TransformerCVN

__all__ = ["CooStemDenseNet", "DecoderLayer", "InducedSetAttentionBlock", "ModelConfig",
           "TransformerCVN"]
