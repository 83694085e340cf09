"""Tensor ops of the port: masked primitives, scatter/gather, losses, the
sparse-grid engine (``ops.sparse``), the general COO convolution, kernel K1
(densify) and kernel K2 (the sparse stem's scatter), each a custom op
(``tcvn::densify``, ``tcvn::coo_stem_scatter``, ``tcvn::coo_stem_bin``)."""

from .coo_conv import (ConvMaps, build_conv_maps, build_conv_maps_numpy, coo_conv_apply,
                       coo_stem_conv)
from .coo_stem import (bin_hits, coo_stem_conv_cuda, scatter_patches, scatter_patches_cuda,
                       scatter_patches_plain, stem_patches)
from .densify import densify_images_cuda, densify_op, densify_images_plain
from .masked import MaskedBatchNorm, PReLU
from .scatter import densify_images, pack_rows, pad_rows

__all__ = [
    "ConvMaps",
    "MaskedBatchNorm",
    "PReLU",
    "bin_hits",
    "build_conv_maps",
    "build_conv_maps_numpy",
    "coo_conv_apply",
    "coo_stem_conv",
    "coo_stem_conv_cuda",
    "densify_images",
    "densify_images_cuda",
    "densify_images_plain",
    "densify_op",
    "pack_rows",
    "pad_rows",
    "scatter_patches",
    "scatter_patches_cuda",
    "scatter_patches_plain",
    "stem_patches",
]
