"""Descriptor extraction: frontend -> backbone -> pooling -> whitening
(port of ``instsearch_tpu/extractor.py``: ``build_extract_fn`` and
``Extractor``).

Eager PyTorch on one device: uint8 ``[B, S, S, 3]`` in, unit-norm ``[B, D]``
f32 out. Multi-scale extraction runs the backbone once per scale and flip
TTA the mirrored batch too; the L2-normalized descriptors are averaged.
Regional (R-MAC) and combined extraction, the data-parallel mesh and the
ViT's tensor-parallel attention are not ported yet (ROADMAP M5, M6, M11).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .data import frontend
from .models import get_backbone
from .models.jax_import import load_jax_resnet, load_jax_vit
from .models.registry import descriptor_dim
from .models.vit import ViT
from .ops import l2_normalize, pool
from .ops.whitening import WhiteningParams, apply_whitening
from .utils.device import resolve_device

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def build_extract_fn(cfg, device=None):
    """Returns ``(model, extract_fn)`` with
    ``extract_fn(images, whitening=None) -> [N, D] f32``; ``images`` is a
    uint8 or [0, 1] float tensor ``[N, S, S, 3]`` on the model's device
    (``device``, the CUDA card by default)."""
    dtype = _DTYPES[cfg.dtype]
    model, _ = get_backbone(cfg.backbone, dtype=dtype, device=device,
                            attention=cfg.vit_attention)

    @torch.inference_mode()
    def extract(images: torch.Tensor,
                whitening: Optional[WhiteningParams] = None) -> torch.Tensor:
        x = frontend.normalize(images, dtype=dtype)
        descs = []
        for scale in cfg.scales:
            xs = frontend.rescale(x, scale)
            variants = (xs, torch.flip(xs, dims=(2,))) if cfg.flip else (xs,)
            for xv in variants:              # flip TTA: mirrored pass too
                d = pool(model(xv), cfg)
                descs.append(l2_normalize(d.float(), dim=-1))
        desc = (torch.stack(descs, 0).mean(0) if len(descs) > 1
                else descs[0])
        desc = l2_normalize(desc, dim=-1)
        if whitening is not None:
            desc = apply_whitening(desc, whitening)      # includes re-L2
        return desc

    return model, extract


class Extractor:
    """Holds the backbone, its weights and the fitted whitening.

    ``variables``: the reference's Flax variables (loaded through
    ``models.jax_import``, by the model's family); None draws seeded random
    weights with Flax's initializer distributions (``init_weights``).
    ``device`` defaults to the CUDA card; without one it raises unless the
    caller passes ``device="cpu"``."""

    def __init__(self, cfg, variables: dict | None = None,
                 whitening: WhiteningParams | None = None, seed: int = 0,
                 device: "torch.device | str | None" = None):
        if cfg.pooling == "rmac":
            raise NotImplementedError(
                "R-MAC extraction is not ported yet (ROADMAP M3/M5)")
        self.cfg = cfg
        self.seed = seed
        self.device = resolve_device(device)
        self.model, self._fn = build_extract_fn(cfg, device=self.device)
        if variables is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed)
            self.model.init_weights(gen)
        elif isinstance(self.model, ViT):
            load_jax_vit(self.model, variables)
        else:
            load_jax_resnet(self.model, variables)
        self.model.eval()
        self.whitening = whitening

    @property
    def descriptor_dim(self) -> int:
        if self.whitening is not None:
            return int(self.whitening.P.shape[0])
        return descriptor_dim(self.cfg)

    def __call__(self, images) -> torch.Tensor:
        """uint8 ``[B, S, S, 3]`` (numpy or tensor) -> ``[B, D]`` f32 on the
        extractor's device."""
        images = torch.as_tensor(np.asarray(images) if not isinstance(
            images, torch.Tensor) else images).to(self.device)
        return self._fn(images, self.whitening)

    def extract_regional(self, images):
        raise NotImplementedError(
            "regional (R-MAC) extraction is not ported yet (ROADMAP M5)")

    def extract_paths_with_regional(self, paths, quarantine=None):
        raise NotImplementedError(
            "combined global + regional extraction is not ported yet "
            "(ROADMAP M5)")

    def extract_paths(self, paths, quarantine: list | None = None):
        """Decode and extract every path in batches of ``cfg.batch_size``.
        Returns ``(descriptors [N, D] f32 numpy, kept_indices [N])``;
        undecodable paths go to ``quarantine``."""
        outs, kept = [], []
        for batch, idxs in frontend.batch_paths(
                paths, self.cfg.image_size, self.cfg.batch_size, quarantine):
            keep = idxs >= 0
            outs.append(self(batch).cpu().numpy()[keep])
            kept.append(idxs[keep])
        if not outs:
            return (np.zeros((0, self.descriptor_dim), np.float32),
                    np.zeros((0,), np.int64))
        return np.concatenate(outs), np.concatenate(kept)
