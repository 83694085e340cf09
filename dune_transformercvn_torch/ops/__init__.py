"""Tensor ops of the port: masked primitives, scatter/gather, losses, kernel
K1 (densify) and kernel K2 (the sparse stem's scatter)."""

from .coo_conv import coo_stem_conv
from .coo_stem import (ScatterPatches, coo_stem_conv_cuda, scatter_patches_cuda,
                       scatter_patches_plain, stem_patches)
from .densify import densify_images_cuda, densify_images_plain
from .masked import MaskedBatchNorm, PReLU
from .scatter import densify_images, pack_rows, pad_rows

__all__ = [
    "MaskedBatchNorm",
    "PReLU",
    "ScatterPatches",
    "coo_stem_conv",
    "coo_stem_conv_cuda",
    "densify_images",
    "densify_images_cuda",
    "densify_images_plain",
    "pack_rows",
    "pad_rows",
    "scatter_patches_cuda",
    "scatter_patches_plain",
    "stem_patches",
]
