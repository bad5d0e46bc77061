"""Hard-negative mining for retrieval fine-tuning (port of
``instsearch_tpu/train/mining.py``; arXiv:1711.02512 §4.3): for each
anchor, the hardest negatives are the highest-scoring pool descriptors of
*other* classes under the current model, mined again every epoch.

One f32 product and a top-k over the pool on the device, then the class
filter and the fill on the host, as the reference's."""
from __future__ import annotations

import numpy as np
import torch

from ..search.bruteforce import select_topk
from ..utils.device import resolve_device


def mine_hard_negatives(pool, pool_labels: np.ndarray, anchors,
                        anchor_labels: np.ndarray, num_negatives: int = 5,
                        overfetch: int = 4,
                        *, device: "torch.device | str | None" = None
                        ) -> np.ndarray:
    """Returns ``[A, num_negatives]`` int64 pool indices: per anchor, the
    top-scoring entries whose label differs from the anchor's (ties in
    position order, as ``lax.top_k``). ``pool [N, D]`` and ``anchors [A,
    D]`` are numpy or tensors; the scores are computed on ``device`` (the
    CUDA card by default). ``overfetch`` sets how many candidates per anchor
    are pulled before the label filter; an anchor left short is filled
    from its other-class entries in a ``default_rng(anchor)`` permutation,
    then by cycling."""
    pool_labels = np.asarray(pool_labels)
    anchor_labels = np.asarray(anchor_labels)
    if len(set(anchor_labels.tolist()) | set(pool_labels.tolist())) < 2:
        raise ValueError("hard-negative mining needs at least 2 classes")
    device = resolve_device(device)
    pool = torch.as_tensor(pool).to(device, torch.float32)
    anchors = torch.as_tensor(anchors).to(device, torch.float32)
    k = min(num_negatives * overfetch + 1, pool.shape[0])
    _, top = select_topk(anchors @ pool.T, k)
    top = top.cpu().numpy()
    out = np.zeros((len(anchors), num_negatives), np.int64)
    for i in range(len(anchors)):
        picked = [int(j) for j in top[i]
                  if pool_labels[j] != anchor_labels[i]]
        if len(picked) < num_negatives:
            others = np.flatnonzero(pool_labels != anchor_labels[i])
            extra = np.random.default_rng(i).permutation(others)
            extra = extra[~np.isin(extra, picked)]
            picked += [int(j) for j in extra[:num_negatives - len(picked)]]
        if not picked:
            raise ValueError(
                f"anchor {i}: no different-class pool entries to mine")
        while len(picked) < num_negatives:   # tiny pools: cycle
            picked += picked[:num_negatives - len(picked)]
        out[i] = picked[:num_negatives]
    return out
