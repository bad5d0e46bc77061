"""Descriptor pooling over NHWC feature maps (port of
``instsearch_tpu/ops/pooling.py``): average, MAC, GeM and R-MAC pooling and
L2 normalization.

The R-MAC region grid is host integer math on the map's (H, W), the
reference's to the box; the regions are static slices of the map."""
from __future__ import annotations

import math

import numpy as np
import torch

EPS = 1e-6


def l2_normalize(x: torch.Tensor, axis: int = -1,
                 eps: float = EPS) -> torch.Tensor:
    """Unit-normalize along ``axis`` so that dot product == cosine
    similarity; the norm is taken in f32, the result keeps ``x``'s
    dtype."""
    norm = torch.sqrt(torch.sum(torch.square(x.float()), dim=axis,
                                keepdim=True))
    return x / torch.clamp(norm, min=eps).to(x.dtype)


def avg_pool(x: torch.Tensor) -> torch.Tensor:
    """Global average pooling: [N,H,W,C] -> [N,C]."""
    return torch.mean(x, dim=(1, 2))


def mac_pool(x: torch.Tensor) -> torch.Tensor:
    """Maximum activation of convolutions: per-channel spatial max."""
    return torch.amax(x, dim=(1, 2))


def gem_pool(x: torch.Tensor, p: float = 3.0, eps: float = EPS) -> torch.Tensor:
    """Generalized-mean pooling ``(mean(clip(x)^p))^(1/p)``, computed in f32
    and returned in ``x``'s dtype."""
    xf = torch.clamp(x.float(), min=eps)
    pooled = torch.mean(xf ** p, dim=(1, 2)) ** (1.0 / p)
    return pooled.to(x.dtype)


# ---------------------------------------------------------------------------
# R-MAC (Tolias et al., arXiv:1511.05879 §3)
# ---------------------------------------------------------------------------

def rmac_region_grid(h: int, w: int, levels: int = 3, overlap: float = 0.4
                     ) -> list[tuple[int, int, int, int]]:
    """R-MAC region boxes ``(y, x, size_y, size_x)`` on an h x w map.

    At level ``l`` (1-based), square regions of side ``2*min(h,w)/(l+1)``
    lie on a uniform grid; the longer axis gets extra steps, the count whose
    consecutive-region overlap is closest to ``overlap``."""
    short = min(h, w)
    steps = np.arange(2, 8)
    if h != w:
        b = (max(h, w) - short) / (steps - 1)
        idx = int(np.argmin(np.abs((short ** 2 - short * b) / short ** 2
                                   - overlap)))
        extra = idx + 1
    else:
        extra = 0
    wd = extra if w > h else 0
    hd = extra if h > w else 0

    regions: list[tuple[int, int, int, int]] = []
    for l in range(1, levels + 1):
        side = int(math.floor(2 * short / (l + 1)))
        if side <= 0:
            continue
        nx, ny = l + wd, l + hd
        bx = (w - side) / (nx - 1) if nx > 1 else 0.0
        by = (h - side) / (ny - 1) if ny > 1 else 0.0
        for i in range(ny):
            for j in range(nx):
                y = min(int(math.floor(i * by)), h - side)
                x = min(int(math.floor(j * bx)), w - side)
                regions.append((y, x, side, side))
    return regions


def rmac_region_geometry(h: int, w: int, levels: int = 3) -> np.ndarray:
    """The grid's regions as ``[R, 3]`` f32 rows ``(cx, cy, log side)`` in
    map coordinates, in the grid's order: the constant that spatial
    verification (``search/spatial.py``) bins region-pair transforms
    against."""
    return np.asarray([(x + sx / 2.0, y + sy / 2.0, math.log(sy))
                       for (y, x, sy, sx) in rmac_region_grid(h, w, levels)],
                      np.float32)


def rmac_regional_descriptors(x: torch.Tensor, levels: int = 3
                              ) -> torch.Tensor:
    """Per-region MAC: [N,H,W,C] -> [N, R, C], in ``x``'s dtype."""
    _, h, w, _ = x.shape
    return torch.stack([torch.amax(x[:, y:y + sy, xx:xx + sx, :], dim=(1, 2))
                        for (y, xx, sy, sx) in rmac_region_grid(h, w, levels)],
                       dim=1)


def rmac_pool(x: torch.Tensor, levels: int = 3,
              whiten: "WhiteningParams | None" = None) -> torch.Tensor:
    """The R-MAC descriptor: per-region MAC -> l2 -> (PCA-whiten) -> sum
    over regions -> l2, with the reference's rounding points: the regions
    are normalized and summed in ``x``'s dtype (the norms in f32, the sum
    accumulated in f32 and rounded once, as ``jnp.sum`` does); ``whiten``
    projects each region in f32 (``apply_whitening``) and rounds it back to
    ``x``'s dtype. The pipelines whiten the pooled descriptor instead and
    pass no ``whiten``, there as here."""
    regional = l2_normalize(rmac_regional_descriptors(x, levels), axis=-1)
    if whiten is not None:
        from .whitening import apply_whitening
        regional = apply_whitening(regional, whiten).to(x.dtype)
    return l2_normalize(torch.sum(regional, dim=1), axis=-1)


_POOLERS = {
    "avg": lambda x, cfg: avg_pool(x),
    "mac": lambda x, cfg: mac_pool(x),
    "gem": lambda x, cfg: gem_pool(x, cfg.gem_p),
    "rmac": lambda x, cfg: rmac_pool(x, cfg.rmac_levels),
}


def pool(x: torch.Tensor, cfg) -> torch.Tensor:
    """Dispatch on ``ExtractConfig.pooling``; returns [N, C] descriptors."""
    try:
        return _POOLERS[cfg.pooling](x, cfg)
    except KeyError:
        raise ValueError(f"unknown pooling {cfg.pooling!r}; expected one of "
                         f"{sorted(_POOLERS)}") from None
