"""Image frontend (port of ``instsearch_tpu/data/frontend.py``).

Host half: decode, shorter-side resize and center crop to a uint8
``[S, S, 3]`` canvas. ``batch_paths`` streams through the native C++
decoder (``native_frontend.py``) where it builds and through cv2 where it
does not, as the reference's does, so both packages start from the same
pixels; ``load_square`` (queries, served requests) decodes with cv2, as
there. cv2 is imported inside the functions that use it, so the device
half imports without it. Device half: ImageNet normalization on a tensor,
computed in f32 and cast to the compute dtype.
"""
from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np
import torch

from ..ops.resize import resize
from ..utils.observe import annotate

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


# ---------------------------------------------------------------------------
# Host side
# ---------------------------------------------------------------------------

def decode_image(path: str) -> np.ndarray | None:
    """Decode to RGB uint8 HWC; None for a corrupt or missing file (the
    caller quarantines it)."""
    import cv2
    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        return None
    return img[:, :, ::-1]  # BGR -> RGB


def resize_shorter_side(img: np.ndarray, target: int) -> np.ndarray:
    """uint8 resize so the shorter side == target (aspect preserved)."""
    import cv2
    h, w = img.shape[:2]
    scale = target / min(h, w)
    nh, nw = max(1, round(h * scale)), max(1, round(w * scale))
    return cv2.resize(img, (nw, nh), interpolation=cv2.INTER_LINEAR)


def center_crop(img: np.ndarray, size: int) -> np.ndarray:
    h, w = img.shape[:2]
    y0 = max(0, (h - size) // 2)
    x0 = max(0, (w - size) // 2)
    return img[y0:y0 + size, x0:x0 + size]


def load_square(path: str, size: int) -> np.ndarray | None:
    """decode -> shorter-side resize -> center crop: uint8 [size, size, 3]."""
    img = decode_image(path)
    if img is None:
        return None
    return center_crop(resize_shorter_side(img, size), size)


def _iter_images(paths: Sequence[str], size: int,
                 quarantine: list | None) -> Iterable[tuple[np.ndarray, int]]:
    """Stream (decoded uint8 [S,S,3], original index), as the reference's
    ``_iter_images``: through the native C++ threaded loader
    (``data/native_frontend.py``) in chunks of 64 when it builds, else one
    image at a time through cv2."""
    from . import native_frontend as nf
    if nf.available():
        chunk = 64
        for start in range(0, len(paths), chunk):
            sub = list(paths[start:start + chunk])
            with annotate("host_decode_native"):   # host-stage attribution
                imgs, ok = nf.load_batch_native(sub, size)
            for j, good in enumerate(ok):
                if good:
                    yield imgs[j], start + j
                elif quarantine is not None:
                    quarantine.append(sub[j])
        return
    for i, p in enumerate(paths):
        img = load_square(p, size)
        if img is None:
            if quarantine is not None:
                quarantine.append(p)
            continue
        yield img, i


def batch_paths(paths: Sequence[str], size: int, batch: int,
                quarantine: list | None = None
                ) -> Iterable[tuple[np.ndarray, np.ndarray]]:
    """Yield (uint8 [B,S,S,3], global index [B]) batches; undecodable paths
    go to ``quarantine``. The final batch is padded by repeating its last
    image with index -1 (callers keep rows with index >= 0)."""
    buf, idxs = [], []
    for img, i in _iter_images(paths, size, quarantine):
        buf.append(img)
        idxs.append(i)
        if len(buf) == batch:
            yield np.stack(buf), np.asarray(idxs)
            buf, idxs = [], []
    if buf:
        pad = batch - len(buf)
        yield (np.stack(buf + [buf[-1]] * pad),
               np.asarray(idxs + [-1] * pad))


# ---------------------------------------------------------------------------
# Device side
# ---------------------------------------------------------------------------

def normalize(images: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """uint8/float [N,H,W,3] -> ImageNet-normalized [N,H,W,3] in ``dtype``.
    uint8 pixels are divided by 255; float images must already lie in
    [0, 1] (Index.query checks)."""
    x = images.to(torch.float32)
    if images.dtype == torch.uint8:
        x = x / 255.0
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=x.device)
    return ((x - mean) / std).to(dtype)


def rescale(images: torch.Tensor, scale: float,
            method: str = "bilinear") -> torch.Tensor:
    """Multi-scale resize of NHWC ``images`` (arXiv:1711.02512) by
    ``method``, any of ``jax.image.resize``'s, computed as the reference's
    ``jax.image.resize`` computes it (``ops/resize.py``): antialiased when
    it shrinks; integer images come back in f32 but for ``nearest``. An
    unknown method raises ``ValueError`` unless the size is unchanged, as
    the reference."""
    n, h, w, c = images.shape
    nh, nw = max(1, round(h * scale)), max(1, round(w * scale))
    if (nh, nw) == (h, w):
        return images
    return resize(images, (nh, nw), method)
