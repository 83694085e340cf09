"""DenseNet embedder whose stem runs sparsely on COO hit banks (``coo``).

Port of ``dune_transformercvn_tpu/models/coo_densenet.py``.  The 7x7/2 stem
runs as :func:`..ops.coo_conv.coo_stem_conv` over the raw hits (kernel K2 on
the card), so the input is never densified at full resolution; after the
stem comes the dense family's body, :func:`.densenet.densenet_post_stem`.

The stem is stored as ``features.conv0.weight`` / ``.bias`` (OIHW), as
:class:`.densenet.DenseNet` stores it, so a dense-family ``state_dict`` loads
unchanged and both families give the same logits (the stem is linear in its
input).  A dense NHWC image input runs the same weights as a plain conv.
"""

from __future__ import annotations

from .densenet import DenseNet, conv_nhwc, densenet_post_stem
from ..ops.coo_conv import coo_stem_conv
from ..parallel.mesh import whole


class CooStemDenseNet(DenseNet):
    """``forward(inputs, mask)``: ``inputs`` is the COO tuple
    ``(xy [R, 2], values [R, C], owner [R], num_rows, starts [num_rows + 1])``
    or a dense NHWC image batch.  The image geometry is fixed at
    construction because the COO input does not carry it."""

    def __init__(self, in_channels: int, output_dim: int, image_height: int,
                 image_width: int, **kwargs):
        super().__init__(in_channels, output_dim, stem_space_to_depth=False, **kwargs)
        self.image_height = image_height
        self.image_width = image_width

    def forward(self, inputs, mask=None):
        conv0 = self.features.conv0
        if isinstance(inputs, (tuple, list)):
            xy, values, owner, num_rows, *rest = inputs
            x = coo_stem_conv(
                xy, values.to(self.compute_dtype), owner,
                whole(conv0.weight).permute(2, 3, 1, 0), conv0.bias, num_rows,
                self.image_height, self.image_width, stride=2, padding=3,
                starts=rest[0] if rest else None,
            )
        else:
            x = conv_nhwc(inputs, conv0.weight, conv0.bias, self.compute_dtype,
                          stride=2, padding=3)
        return densenet_post_stem(self, x, mask)
