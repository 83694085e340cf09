"""Tensor ops of the port: masked primitives, scatter/gather, kernel K1."""

from .densify import densify_images_cuda, densify_images_plain
from .masked import MaskedBatchNorm, PReLU
from .scatter import densify_images, pack_rows, pad_rows

__all__ = [
    "MaskedBatchNorm",
    "PReLU",
    "densify_images",
    "densify_images_cuda",
    "densify_images_plain",
    "pack_rows",
    "pad_rows",
]
