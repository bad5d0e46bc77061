"""Benchmark evaluation (port of ``instsearch_tpu/eval/evaluate.py``):
dataset -> query extraction with the protocol's bbox crop -> optional
alpha-QE -> full ranking -> the re-ranked (refined, diffused or
local-whitened) head spliced in -> mAP, on one device or through a sharded
index."""
from __future__ import annotations

import numpy as np
import torch

from ..data import frontend
from ..search.qe import alpha_query_expansion
from ..utils.observe import COUNTERS, annotate
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


def extract_query_regional(index, dataset: RetrievalDataset,
                           crop_bbx: bool = True) -> np.ndarray:
    """Per-query regional R-MAC rows (bbox-cropped) for re-ranking."""
    ex = index.extractor
    if ex is None:
        raise ValueError("index has no extractor attached")
    imgs = _load_query_images(dataset, ex.cfg.image_size, crop_bbx)
    return _batched_apply(ex.extract_regional, imgs, ex.cfg.batch_size)


def _splice_head(ranks: np.ndarray, top_ids: np.ndarray) -> np.ndarray:
    """Per query, ``top_ids`` first (the re-ranked head, empty slots -1
    dropped), then the rest of ``ranks`` without the head, in its order.
    Membership is one table lookup: a [Q, max_id + 1] indicator scattered
    from the heads and gathered along the rankings."""
    spliced = np.empty_like(ranks)
    with annotate("splice_head"):      # host-stage attribution in traces
        valid = top_ids >= 0
        width = int(ranks.max(initial=0)) + 1
        member = np.zeros((ranks.shape[0], width), np.bool_)
        qq, jj = np.nonzero(valid)
        member[qq, top_ids[qq, jj]] = True
        in_head = np.take_along_axis(member, ranks, axis=1)    # [Q, N]
        for qi in range(ranks.shape[0]):
            head = top_ids[qi][valid[qi]].astype(ranks.dtype)
            spliced[qi, :len(head)] = head
            spliced[qi, len(head):] = ranks[qi][~in_head[qi]]
    return spliced


def evaluate_index(index, dataset: RetrievalDataset, protocol: str = "medium",
                   search_cfg=None, crop_bbx: bool = True,
                   sharded_index=None, include_ranks: bool = False) -> dict:
    """Full protocol evaluation: mAP / mP@k on the complete ranking. Alpha-QE
    from ``search_cfg`` expands the queries first, through the oracle over
    the whole store (``search/qe.py::alpha_query_expansion``), as the
    reference does. With ``rerank_enabled`` (and a regional store) or
    ``refine_enabled`` or ``lw_enabled``, the top-``rerank_depth`` of that
    ranking is replaced by the composite's re-scored head (``Index.search``),
    with ``diffusion_enabled`` the top-``diffusion_depth`` by the diffused
    head; the tail keeps its global order. ``stages_applied`` lists the stages that ran.
    ``sharded_index`` (``Index.to_sharded()``) routes the expansion, the
    ranking and the heads through the sharded machinery instead: the same
    math, row-sharded; extraction stays on the index's extractor."""
    index._check_rescoring_cfg(search_cfg or index.cfg.search)
    scfg = search_cfg or index.cfg.search
    ex = index.extractor
    if ex is None:
        raise ValueError("index has no extractor attached")
    qimgs = _load_query_images(dataset, ex.cfg.image_size, crop_bbx)
    queries = _batched_apply(ex, qimgs, ex.cfg.batch_size)
    q = index._match_query_dim(torch.as_tensor(queries, device=index.device))
    applied = []        # the stages this evaluation ran
    # a placed index (Index.load(mesh=)) ranks through its placement
    sidx = sharded_index if sharded_index is not None else index.placement
    if scfg.qe_enabled:
        applied.append("qe")
        if sidx is not None:
            q = sidx.expand_queries(q, qe_n=scfg.qe_n, alpha=scfg.qe_alpha)
        else:
            q = alpha_query_expansion(index.descriptors, index.ids, q,
                                      n=scfg.qe_n, alpha=scfg.qe_alpha,
                                      scales=index.scales,
                                      int4=index.is_int4)
    ranks = (sidx or index).full_ranking(q)
    depth = min(scfg.rerank_depth, index.n_pad)
    if scfg.rerank_enabled and index.has_regional:
        applied.append("rerank")
        if scfg.spatial_weight:
            applied.append("spatial")
        query_regional = _batched_apply(ex.extract_regional, qimgs,
                                        ex.cfg.batch_size)
        if sidx is not None:
            _, top_ids = sidx.search_rerank(
                q, query_regional, k=depth, depth=depth,
                spatial_weight=scfg.spatial_weight)
            top_ids = top_ids.cpu().numpy()
        else:
            _, top_ids = index.search(
                q, scfg.replace(qe_enabled=False, k=depth,
                                rerank_depth=depth),
                query_regional=query_regional)
        ranks = _splice_head(ranks, top_ids)
    if scfg.refine_enabled:
        applied.append("refine")
        if sidx is not None:
            top_ids = sidx.search_refine(q, k=depth, depth=depth)[1]
            top_ids = top_ids.cpu().numpy()
        else:
            _, top_ids = index.search(q, scfg.replace(qe_enabled=False,
                                                      k=depth))
        ranks = _splice_head(ranks, top_ids)
    if scfg.diffusion_enabled:
        applied.append("diffusion")
        depth = min(scfg.diffusion_depth, index.n_pad)
        if sidx is not None:
            top_ids = sidx.search_diffusion(
                q, k=depth, depth=depth, knn=scfg.diffusion_knn,
                alpha=scfg.diffusion_alpha, iters=scfg.diffusion_iters,
                seeds=scfg.diffusion_seeds)[1].cpu().numpy()
        else:
            _, top_ids = index.search(q, scfg.replace(qe_enabled=False,
                                                      k=depth))
        ranks = _splice_head(ranks, top_ids)
    if scfg.lw_enabled:
        applied.append("lw")
        depth = min(scfg.rerank_depth, index.n_pad)
        if sidx is not None:
            top_ids = sidx.search_lw(q, k=depth, depth=depth)[1]
            top_ids = top_ids.cpu().numpy()
        else:
            _, top_ids = index.search(q, scfg.replace(qe_enabled=False,
                                                      k=depth))
        ranks = _splice_head(ranks, top_ids)
    res = evaluate_ranks(ranks, dataset.gnd, protocol)
    res["dataset"] = dataset.name
    res["protocol"] = protocol
    res["stages_applied"] = applied
    if include_ranks:
        res["ranks"] = ranks
    COUNTERS.add("queries_evaluated", ranks.shape[0])
    return res


def build_index_for_dataset(dataset: RetrievalDataset, cfg,
                            variables: dict | None = None, seed: int = 0,
                            device: "torch.device | str | None" = None):
    """``Index.build`` over the dataset's database images, on ``device``
    (the CUDA card by default)."""
    from ..index import Index
    return Index.build(dataset.db_paths, cfg, variables=variables, seed=seed,
                       device=device)
