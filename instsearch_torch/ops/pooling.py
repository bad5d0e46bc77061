"""Descriptor pooling over NHWC feature maps (port of
``instsearch_tpu/ops/pooling.py``): average, MAC and GeM pooling and L2
normalization. R-MAC is not ported yet (ROADMAP M3/M5)."""
from __future__ import annotations

import torch

EPS = 1e-6


def l2_normalize(x: torch.Tensor, dim: int = -1,
                 eps: float = EPS) -> torch.Tensor:
    """Unit-normalize so that dot product == cosine similarity; the norm is
    taken in f32, the result keeps ``x``'s dtype."""
    norm = torch.sqrt(torch.sum(torch.square(x.float()), dim=dim,
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


_POOLERS = {
    "avg": lambda x, cfg: avg_pool(x),
    "mac": lambda x, cfg: mac_pool(x),
    "gem": lambda x, cfg: gem_pool(x, cfg.gem_p),
}


def pool(x: torch.Tensor, cfg) -> torch.Tensor:
    """Dispatch on ``ExtractConfig.pooling``; returns [N, C] descriptors."""
    if cfg.pooling == "rmac":
        raise NotImplementedError(
            "R-MAC pooling is not ported yet (ROADMAP M3/M5)")
    try:
        return _POOLERS[cfg.pooling](x, cfg)
    except KeyError:
        raise ValueError(f"unknown pooling {cfg.pooling!r}; expected one of "
                         f"{sorted(_POOLERS) + ['rmac']}") from None
