"""Models of the port (dense embedder family)."""

from .network import ModelConfig, TransformerCVN

__all__ = ["ModelConfig", "TransformerCVN"]
