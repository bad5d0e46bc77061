"""Resize of NHWC tensors with ``jax.image.resize``'s arithmetic.

``jax.image.resize`` samples at half-pixel centres. Its interpolating
methods (``linear``, ``cubic``, ``lanczos3``, ``lanczos5``) weight the input
by a kernel that, when an axis shrinks, is widened by the scale factor
(antialiasing); the weights of each output sample are normalized to sum to
one, and samples whose centre falls outside the input get none. Integer
input is computed and returned in f32. ``nearest`` takes the input sample
under each output centre and keeps the dtype.

``F.interpolate(mode="bilinear", align_corners=False, antialias=True)``
computes ``linear``'s weights, in both directions (growing, its antialias
changes nothing); without ``antialias`` a shrink differs by up to the data's
range. ``resize_bilinear`` is that path, taken by :func:`resize` for float
images and by the ViT's position-grid resize (``models/vit.py``). The
other methods have no ``F.interpolate`` twin (its bicubic uses a = -0.75
and no widening; it has no Lanczos), so :func:`resize` builds each axis's
``[in, out]`` weight matrix as ``jax.image.resize`` does
(``compute_weight_mat``, in f32) and contracts the image with it, one axis
at a time; the multi-scale frontend (``data/frontend.py::rescale``) calls
:func:`resize`.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

# jax.image.ResizeMethod.from_string's spellings
_METHODS = {"nearest": "nearest", "linear": "linear", "bilinear": "linear",
            "trilinear": "linear", "triangle": "linear", "cubic": "cubic",
            "bicubic": "cubic", "tricubic": "cubic", "lanczos3": "lanczos3",
            "lanczos5": "lanczos5"}


def resize_bilinear(x: torch.Tensor, size: "tuple[int, int]") -> torch.Tensor:
    """``x [N, H, W, C]`` -> ``[N, oh, ow, C]`` in ``x``'s dtype, computed in
    f32."""
    oh, ow = size
    y = F.interpolate(x.permute(0, 3, 1, 2).float(), size=(oh, ow),
                      mode="bilinear", align_corners=False, antialias=True)
    return y.permute(0, 2, 3, 1).to(x.dtype)


def _triangle(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1.0 - x.abs(), min=0.0)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys' cubic convolution kernel, a = -0.5."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _lanczos(radius: float):
    def kernel(x: torch.Tensor) -> torch.Tensor:
        y = radius * torch.sin(math.pi * x) * torch.sin(math.pi * x / radius)
        den = torch.where(x != 0, math.pi ** 2 * (x * x), torch.ones_like(x))
        out = torch.where(x > 1e-3, y / den, torch.ones_like(x))
        return torch.where(x > radius, torch.zeros_like(x), out)
    return kernel


_KERNELS = {"linear": _triangle, "cubic": _keys_cubic,
            "lanczos3": _lanczos(3.0), "lanczos5": _lanczos(5.0)}


def _weight_matrix(n_in: int, n_out: int, kernel) -> torch.Tensor:
    """``[n_in, n_out]`` f32 weights of one axis, ``jax.image``'s
    ``compute_weight_mat`` at scale ``n_out / n_in``, no translation,
    antialiased."""
    inv_scale = torch.tensor(1.0 / (n_out / n_in), dtype=torch.float32)
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample = ((torch.arange(n_out, dtype=torch.float32) + 0.5) * inv_scale
              - 0.5)
    dist = (sample[None, :]
            - torch.arange(n_in, dtype=torch.float32)[:, None]).abs()
    w = kernel(dist / kernel_scale)
    total = w.sum(dim=0, keepdim=True)
    eps = 1000.0 * torch.finfo(torch.float32).eps
    w = torch.where(total.abs() > eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def _nearest(x: torch.Tensor, size: "tuple[int, int]") -> torch.Tensor:
    for axis, n in zip((1, 2), size):
        m = x.shape[axis]
        if m == n:
            continue
        at = torch.floor((torch.arange(n, dtype=torch.float32) + 0.5) * m
                         / n).to(torch.int64)
        x = x.index_select(axis, at.to(x.device))
    return x


def resize(x: torch.Tensor, size: "tuple[int, int]",
           method: str = "bilinear") -> torch.Tensor:
    """``x [N, H, W, C]`` -> ``[N, oh, ow, C]`` by ``method``, any of
    ``jax.image.resize``'s names (an unknown one raises ``ValueError``, as
    there). ``nearest`` keeps ``x``'s dtype; the others return a float
    ``x``'s dtype and f32 for integer input, computed in f32 with the
    weights rounded to that dtype first, as ``jax.image.resize`` rounds
    them; a float image's ``linear`` takes :func:`resize_bilinear`."""
    try:
        kind = _METHODS[method]
    except (KeyError, TypeError):
        raise ValueError(f'Unknown resize method "{method}"') from None
    if kind == "nearest":
        return _nearest(x, size)
    if kind == "linear" and x.is_floating_point():
        return resize_bilinear(x, size)
    dtype = x.dtype if x.is_floating_point() else torch.float32
    y = x.to(dtype)
    for axis, n in zip((1, 2), size):
        m = y.shape[axis]
        if m == n:
            continue
        w = _weight_matrix(m, n, _KERNELS[kind]).to(y.device, dtype)
        y = torch.movedim(torch.tensordot(y.float(), w.float(),
                                          dims=([axis], [0])), -1, axis)
        y = y.to(dtype)
    return y
