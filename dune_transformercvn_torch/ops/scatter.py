"""COO <-> dense image / sequence scatter-gather with static shapes.

Port of ``dune_transformercvn_tpu/ops/scatter.py``.  Padding rows carry
out-of-range indices and are dropped, as JAX's ``mode="drop"`` does; torch
indexing raises on out-of-range indices and wraps negative ones, so the
dropping is written out here.
"""

from __future__ import annotations

from typing import Optional

import torch

from .densify import densify_images_cuda, densify_images_plain


def densify_images(
    xy: torch.Tensor,       # [R, 2] int32 pixel coordinates
    values: torch.Tensor,   # [R, C] pixel values
    owner: torch.Tensor,    # [R] int32 image index; >= num_images means padding
    num_images: int,
    height: int,
    width: int,
    starts: Optional[torch.Tensor] = None,   # [num_images + 1] CSR offsets
    space_to_depth: bool = False,
) -> torch.Tensor:
    """Scatter-add COO hits into dense NHWC images ``[N, H, W, C]``, or the
    2x2 space-to-depth layout ``[N, H/2, W/2, 4C]``.

    CPU tensors take the plain version.  CUDA tensors take kernel K1, which
    reads the bank through ``starts`` (the batcher always supplies them).
    """
    if space_to_depth and (height % 2 or width % 2):
        raise ValueError(f"space_to_depth needs even H, W; got {height}x{width}")
    if values.device.type == "cpu":
        return densify_images_plain(
            xy, values, owner, num_images, height, width, space_to_depth)
    if starts is None:
        raise ValueError(
            "densify_images on the GPU needs the bank's CSR `starts` "
            "(Batcher.build_batch provides event_starts / prong_starts)")
    return densify_images_cuda(
        xy, values, starts, num_images, height, width, space_to_depth)


def pack_rows(
    data: torch.Tensor,        # [B, L, ...]
    slot_batch: torch.Tensor,  # [P] event row per packed slot
    slot_pos: torch.Tensor,    # [P] position within event
) -> torch.Tensor:
    """Gather padded ``[B, L, ...]`` rows into packed ``[P, ...]`` layout.

    Indices are clipped, so padding slots (``slot_batch == B``) read row
    ``B-1``; callers mask them downstream.
    """
    return data[
        slot_batch.long().clamp(0, data.shape[0] - 1),
        slot_pos.long().clamp(0, data.shape[1] - 1),
    ]


def pad_rows(
    packed: torch.Tensor,      # [P, C]
    slot_batch: torch.Tensor,  # [P]
    slot_pos: torch.Tensor,    # [P]
    batch_size: int,
    max_length: int,
) -> torch.Tensor:
    """Scatter packed rows back to ``[B, L, C]``; padding slots are dropped.

    As JAX does, a negative index wraps once and an index still out of range
    is dropped: dropped rows go to a spare row that is cut off.
    """
    b, p = slot_batch.long(), slot_pos.long()
    b = torch.where(b < 0, b + batch_size, b)
    p = torch.where(p < 0, p + max_length, p)
    keep = (b >= 0) & (b < batch_size) & (p >= 0) & (p < max_length)
    flat = torch.where(keep, b * max_length + p, batch_size * max_length)
    out = packed.new_zeros((batch_size * max_length + 1, packed.shape[-1]))
    out[flat] = packed
    return out[:-1].reshape(batch_size, max_length, packed.shape[-1])
