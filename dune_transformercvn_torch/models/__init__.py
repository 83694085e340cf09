"""Models of the port (dense and coo embedder families)."""

from .coo_densenet import CooStemDenseNet
from .network import ModelConfig, TransformerCVN

__all__ = ["CooStemDenseNet", "ModelConfig", "TransformerCVN"]
