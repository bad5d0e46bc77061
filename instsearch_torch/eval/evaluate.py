"""Benchmark evaluation (port of ``instsearch_tpu/eval/evaluate.py``,
the single-device path with its alpha-QE stage, without the re-rank
stages): dataset -> query extraction with the protocol's bbox crop ->
optional alpha-QE -> full ranking -> mAP."""
from __future__ import annotations

import numpy as np
import torch

from ..data import frontend
from ..search.qe import alpha_query_expansion
from .datasets import RetrievalDataset
from .revisited import evaluate_ranks


def load_query_batchable(path: str, bbx, size: int) -> np.ndarray | None:
    """Decode, crop to the query bbox (x1,y1,x2,y2 in original pixels,
    revisited-kit convention), then shorter-side resize + center crop."""
    img = frontend.decode_image(path)
    if img is None:
        return None
    if bbx is not None:
        x1, y1, x2, y2 = (int(round(v)) for v in bbx)
        h, w = img.shape[:2]
        x1, y1 = max(0, x1), max(0, y1)
        x2, y2 = min(w, max(x2, x1 + 1)), min(h, max(y2, y1 + 1))
        img = img[y1:y2, x1:x2]
    return frontend.center_crop(frontend.resize_shorter_side(img, size), size)


def _load_query_images(dataset: RetrievalDataset, size: int,
                       crop_bbx: bool) -> list[np.ndarray]:
    """Decode + crop every query once; FileNotFoundError on a bad decode."""
    imgs = []
    for qname, entry in zip(dataset.qimlist, dataset.gnd):
        img = load_query_batchable(dataset.image_path(qname),
                                   entry.get("bbx") if crop_bbx else None,
                                   size)
        if img is None:
            raise FileNotFoundError(dataset.image_path(qname))
        imgs.append(img)
    return imgs


def _batched_apply(fn, imgs: list[np.ndarray], batch: int) -> np.ndarray:
    """Run ``fn`` over batches of at most ``batch`` images."""
    return np.concatenate([fn(np.stack(imgs[i:i + batch])).cpu().numpy()
                           for i in range(0, len(imgs), batch)])


def extract_queries(index, dataset: RetrievalDataset,
                    crop_bbx: bool = True) -> np.ndarray:
    """Query descriptors with per-query bbox cropping (whitening inside)."""
    ex = index.extractor
    if ex is None:
        raise ValueError("index has no extractor attached")
    imgs = _load_query_images(dataset, ex.cfg.image_size, crop_bbx)
    return _batched_apply(ex, imgs, ex.cfg.batch_size)


def evaluate_index(index, dataset: RetrievalDataset, protocol: str = "medium",
                   search_cfg=None, crop_bbx: bool = True,
                   include_ranks: bool = False) -> dict:
    """Full protocol evaluation: mAP / mP@k on the complete ranking. Alpha-QE
    from ``search_cfg`` expands the queries first, through the oracle over
    the whole store (``search/qe.py::alpha_query_expansion``), as the
    reference does."""
    from ..index import _check_search_cfg
    scfg = search_cfg or index.cfg.search
    _check_search_cfg(scfg)
    queries = extract_queries(index, dataset, crop_bbx)
    q = index._match_query_dim(torch.as_tensor(queries, device=index.device))
    applied = []        # the stages this evaluation ran
    if scfg.qe_enabled:
        applied.append("qe")
        q = alpha_query_expansion(index.descriptors, index.ids, q,
                                  n=scfg.qe_n, alpha=scfg.qe_alpha,
                                  scales=index.scales, int4=index.is_int4)
    ranks = index.full_ranking(q)
    res = evaluate_ranks(ranks, dataset.gnd, protocol)
    res["dataset"] = dataset.name
    res["protocol"] = protocol
    res["stages_applied"] = applied
    if include_ranks:
        res["ranks"] = ranks
    return res
