"""Bilinear resize of NHWC tensors with ``jax.image.resize``'s arithmetic.

``jax.image.resize(method="bilinear")`` samples at half-pixel centres and,
when it shrinks an axis, widens the triangle kernel by the scale factor
(antialiasing). ``F.interpolate(mode="bilinear", align_corners=False,
antialias=True)`` computes the same weights, in both directions (growing,
its antialias changes nothing); without ``antialias`` a shrink differs by up
to the data's range. Used by the multi-scale frontend
(``data/frontend.py::rescale``) and the ViT's position-grid resize
(``models/vit.py``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, size: "tuple[int, int]") -> torch.Tensor:
    """``x [N, H, W, C]`` -> ``[N, oh, ow, C]`` in ``x``'s dtype, computed in
    f32."""
    oh, ow = size
    y = F.interpolate(x.permute(0, 3, 1, 2).float(), size=(oh, ow),
                      mode="bilinear", align_corners=False, antialias=True)
    return y.permute(0, 2, 3, 1).to(x.dtype)
