"""Retrieval datasets of the port: the ``RetrievalDataset`` record and the
deterministic synthetic "mini" fixture (the port's copy of
``instsearch_tpu/eval/datasets.py::RetrievalDataset`` and
``make_mini_dataset``; the port imports nothing of the JAX package). The
on-disk loaders of ROxford/RParis and classic Oxford/Paris are not ported
yet (ROADMAP M10, with the CLI)."""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np


@dataclass
class RetrievalDataset:
    name: str
    image_root: str
    imlist: list[str]              # database image names (no extension)
    qimlist: list[str]             # query image names
    gnd: list[dict]                # per-query: easy/hard/junk (+ bbx)
    ext: str = ".jpg"

    def image_path(self, name: str) -> str:
        # distractor entries carry their own path
        if os.sep in name:
            return name + self.ext
        return os.path.join(self.image_root, name + self.ext)

    @property
    def db_paths(self) -> list[str]:
        return [self.image_path(n) for n in self.imlist]

    @property
    def query_paths(self) -> list[str]:
        return [self.image_path(n) for n in self.qimlist]


def make_mini_dataset(root: str, n_instances: int = 8, n_views: int = 4,
                      n_distractors: int = 8, size: int = 64,
                      seed: int = 0) -> RetrievalDataset:
    """Deterministic synthetic instance-retrieval dataset.

    Each instance is a random low-frequency base pattern; database "views"
    are the base under small shift + noise + brightness jitter; queries are
    held-out views. Distractors are independent patterns. Ground truth:
    near-identical views are 'easy', heavier-corrupted ones 'hard', one
    extreme view per instance is 'junk'.
    """
    import cv2

    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "jpg"), exist_ok=True)

    def base_pattern():
        low = rng.random((size // 8, size // 8, 3), dtype=np.float32)
        img = cv2.resize(low, (size, size), interpolation=cv2.INTER_CUBIC)
        return np.clip(img, 0, 1)

    def view(base, shift, noise, gain):
        img = np.roll(base, shift, axis=(0, 1)) * gain
        img = img + rng.normal(0, noise, base.shape).astype(np.float32)
        return np.clip(img, 0, 1)

    def save(name, img):
        path = os.path.join(root, "jpg", name + ".jpg")
        cv2.imwrite(path, (img * 255).astype(np.uint8)[:, :, ::-1])

    imlist, qimlist, gnd = [], [], []
    for inst in range(n_instances):
        base = base_pattern()
        easy, hard, junk = [], [], []
        for v in range(n_views):
            name = f"inst{inst:02d}_v{v}"
            save(name, view(base, (rng.integers(-2, 3), rng.integers(-2, 3)),
                            0.02, rng.uniform(0.95, 1.05)))
            easy.append(len(imlist))
            imlist.append(name)
        name = f"inst{inst:02d}_hard"
        save(name, view(base, (size // 6, size // 6), 0.10, 0.8))
        hard.append(len(imlist))
        imlist.append(name)
        name = f"inst{inst:02d}_junk"
        save(name, view(base, (size // 3, size // 3), 0.35, 0.6))
        junk.append(len(imlist))
        imlist.append(name)
        qname = f"query{inst:02d}"
        save(qname, view(base, (rng.integers(-2, 3), rng.integers(-2, 3)),
                         0.02, 1.0))
        qimlist.append(qname)
        gnd.append({"easy": easy, "hard": hard, "junk": junk,
                    "bbx": [0, 0, size, size]})
    for d in range(n_distractors):
        name = f"distractor{d:02d}"
        save(name, base_pattern())
        imlist.append(name)
    return RetrievalDataset(name="mini", image_root=os.path.join(root, "jpg"),
                            imlist=imlist, qimlist=qimlist, gnd=gnd)
