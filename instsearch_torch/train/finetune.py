"""Fine-tuning orchestration (port of ``instsearch_tpu/train/finetune.py``;
arXiv:1711.02512 §4): epochs of { extract the pool's descriptors -> mine
hard negatives -> train on (anchor, positive, negatives) tuples }, then
hand the tuned weights back to the extraction and indexing stack.

Training data is class-labelled images (same instance or landmark); any
``(paths, labels)`` pairing works."""
from __future__ import annotations

import numpy as np
import torch

from ..config import ExtractConfig
from ..data import frontend
from ..extractor import Extractor
from ..ops.whitening import fit_lw_whitening
from ..utils.observe import get_logger
from .mining import mine_hard_negatives
from .trainer import Trainer

log = get_logger("instsearch.finetune")


def _load_images(paths, size: int) -> np.ndarray:
    imgs = []
    for p in paths:
        img = frontend.load_square(p, size)
        if img is None:
            raise FileNotFoundError(p)
        imgs.append(img)
    return np.stack(imgs)


def _pool(trainer: Trainer, cfg, paths) -> np.ndarray:
    """The pool's descriptors under the trainer's current weights (f32),
    row for row with ``paths``: a dropped image would shift every later row
    onto another label."""
    ex = Extractor(ExtractConfig(
        backbone=cfg.backbone, pooling=cfg.pooling, gem_p=trainer.gem_p,
        image_size=cfg.image_size, batch_size=cfg.batch_size * 4,
        dtype="float32"), variables=trainer.variables, device=trainer.device)
    pool, kept = ex.extract_paths(paths)
    if len(kept) != len(paths) or not np.array_equal(
            kept, np.arange(len(paths))):
        bad = sorted(set(range(len(paths))) - set(int(i) for i in kept))
        raise ValueError(
            f"finetune pool extraction dropped images at positions "
            f"{bad[:5]}{'...' if len(bad) > 5 else ''}; remove or fix "
            f"them (labels would misalign)")
    return pool


def finetune(paths, labels, cfg, epochs: int = 1,
             steps_per_epoch: int | None = None, mesh=None, seed: int = 0,
             variables: dict | None = None, fit_lw: bool = False,
             lw_dim: int = 0,
             *, device: "torch.device | str | None" = None) -> dict:
    """Returns ``{"variables": the tuned backbone's state_dict, "gem_p",
    "losses": [...], "trainer"}`` (and ``"whitening"`` with ``fit_lw``).

    Each epoch extracts the pool with the *current* weights and mines hard
    negatives again (ibid. §4.3), then steps over anchor/positive pairs of
    same-label images in a ``default_rng(seed)`` order, wrapping around.
    ``fit_lw`` fits Lw discriminative whitening (ibid. §3.4) on the pairs
    with the final weights (a ``WhiteningParams`` for ``Index.build(
    whitening=...)``); ``lw_dim`` 0 keeps every dimension. Runs on
    ``device``, the CUDA card by default."""
    labels = np.asarray(labels)
    paths = list(paths)
    trainer = Trainer(cfg, mesh=mesh, seed=seed, variables=variables,
                      device=device)
    images = _load_images(paths, cfg.image_size)
    rng = np.random.default_rng(seed)
    losses: list[float] = []

    by_label: dict = {}
    for i, label in enumerate(labels):
        by_label.setdefault(int(label), []).append(i)
    pairs = [(a, p) for group in by_label.values() if len(group) >= 2
             for a in group for p in group if a != p]
    if not pairs:
        raise ValueError("need at least one label with >= 2 images")
    anchor_idx = np.asarray([a for a, _ in pairs])

    for epoch in range(epochs):
        pool = _pool(trainer, cfg, paths)
        negs = mine_hard_negatives(pool, labels, pool[anchor_idx],
                                   labels[anchor_idx],
                                   num_negatives=cfg.num_negatives,
                                   device=trainer.device)
        order = rng.permutation(len(pairs))
        n_steps = steps_per_epoch or max(1, len(pairs) // cfg.batch_size)
        for step in range(n_steps):
            take = order[(step * cfg.batch_size) % len(pairs):][
                :cfg.batch_size]
            if len(take) < cfg.batch_size:   # wrap around
                take = np.concatenate(
                    [take, order[:cfg.batch_size - len(take)]])
            batch_idx = [[pairs[j][0], pairs[j][1], *negs[j]] for j in take]
            losses.append(trainer.step(images[np.asarray(batch_idx)])["loss"])
        log.info("epoch %d: loss %.4f -> %.4f", epoch, losses[-n_steps],
                 losses[-1])

    out = {"variables": trainer.variables, "gem_p": trainer.gem_p,
           "losses": losses, "trainer": trainer}
    if fit_lw:
        pool = torch.as_tensor(_pool(trainer, cfg, paths),
                               device=trainer.device)
        p_idx = np.asarray([p for _, p in pairs])
        out["whitening"] = fit_lw_whitening(pool[anchor_idx], pool[p_idx],
                                            dim=lw_dim or None)
        log.info("fit Lw whitening on %d pairs (dim=%s)", len(pairs),
                 lw_dim or "full")
    return out
