"""Regional re-ranking (port of ``instsearch_tpu/search/rerank.py``; Tolias
et al., arXiv:1511.05879 §4).

The top-``depth`` candidates of the global search are re-scored by matching
the query's R-MAC regional descriptors against each candidate's: for every
query region the best-matching candidate region, averaged over the query
regions, plus the global cosine. Plain tensor code: a gather, one batched
f32 product, a max and a sum, as the reference computes them outside any
Pallas kernel. Empty candidate slots (global score -inf) are never
promoted.

The stage's parts run under profiler ranges (``rerank.gather``,
``rerank.products``, ``rerank.match``, ``rerank.vote``, ``rerank.select``),
which ``tools/profile_query.py`` reads to split a query's device time; with
no profiler active each range costs a few microseconds of host time.
"""
from __future__ import annotations

import torch
from torch.profiler import record_function

from .bruteforce import select_topk
from .spatial import spatial_consistency_scores


def region_similarities(regional_store, top_pos: torch.Tensor,
                        query_regional: torch.Tensor,
                        regional_scales: "torch.Tensor | None" = None
                        ) -> torch.Tensor:
    """Region-pair similarities for the candidate rows ``top_pos [Q,
    depth]``: the ``[Q, depth, R, D]`` candidate regions gathered from
    ``regional_store [N_pad, R, D]`` -> ``sim [Q, depth, Rq, R]`` f32. An
    int8 store is not dequantized first: its per-(row, region) scale
    factors out of the product over D and multiplies ``sim``.
    ``regional_store`` may instead be a reader ``pos -> (regions [..., R,
    D] in the store's dtype, their scales [..., R] or None)`` that reads
    only the candidates' rows wherever the store lies (a placed store's:
    ``Index._regions_at``); ``regional_scales`` is then unused."""
    pos = top_pos.clamp(min=0).long()
    with record_function("rerank.gather"):
        if callable(regional_store):
            cand, cand_scales = regional_store(pos)
        else:
            cand, cand_scales = regional_store[pos], (
                None if regional_scales is None else regional_scales[pos])
        cand = cand.float()
    with record_function("rerank.products"):
        sim = torch.einsum("qrd,qcsd->qcrs", query_regional.float(), cand)
        if cand_scales is not None:
            sim = sim * cand_scales[:, :, None, :]
    return sim


def region_match_scores(regional_store: torch.Tensor, top_pos: torch.Tensor,
                        query_regional: torch.Tensor,
                        regional_scales: "torch.Tensor | None" = None
                        ) -> torch.Tensor:
    """The regional match ``[Q, depth]``: the best candidate region per
    query region, averaged over the query regions."""
    sim = region_similarities(regional_store, top_pos, query_regional,
                              regional_scales)
    return sim.amax(dim=-1).sum(dim=-1) / query_regional.shape[1]


def fused_scores(sim: torch.Tensor, top_g: torch.Tensor, keep: torch.Tensor,
                 *, fuse_weight: float = 1.0, spatial_weight: float = 0.0,
                 vote_matrix=None) -> torch.Tensor:
    """The fused score ``[Q, depth]`` of candidates with region-pair
    similarities ``sim [Q, depth, Rq, R]`` and global scores ``top_g``:
    the regional match, plus ``fuse_weight`` * ``top_g``, plus
    ``spatial_weight`` * the spatial vote (with a ``vote_matrix``), summed
    in that order; -inf where ``keep`` is false. The single-device stage
    and the sharded one (``parallel/sharded_index.py``) both score here."""
    with record_function("rerank.match"):
        fused = sim.amax(dim=-1).sum(dim=-1) / sim.shape[2] \
            + fuse_weight * top_g
    if spatial_weight and vote_matrix is not None:
        with record_function("rerank.vote"):
            fused = fused + spatial_weight * spatial_consistency_scores(
                sim, vote_matrix)
    # after the sum: with fuse_weight 0 an empty slot is 0 * -inf = NaN
    return torch.where(keep, fused, torch.full_like(fused, float("-inf")))


def rerank_from_candidates(regional_store, ids: torch.Tensor,
                           top_g: torch.Tensor, top_pos: torch.Tensor,
                           query_regional: torch.Tensor, *, k: int = 10,
                           fuse_weight: float = 1.0,
                           regional_scales: "torch.Tensor | None" = None,
                           spatial_weight: float = 0.0, vote_matrix=None):
    """Re-rank pre-selected candidates ``top_g/top_pos [Q, depth]`` (from
    the fused top-k kernel, or the oracle) -> ``(scores [Q, k], ids [Q,
    k])`` by the fused score: regional match + ``spatial_weight`` * spatial
    consistency (with a ``vote_matrix``) + ``fuse_weight`` * global cosine.
    ``regional_store``: the store, or a reader of its rows
    (:func:`region_similarities`). Ties go to the lower candidate slot, as
    ``lax.top_k`` gives them; a ``k`` past ``depth`` pads with ``(-inf,
    -1)``."""
    sim = region_similarities(regional_store, top_pos, query_regional,
                              regional_scales)
    fused = fused_scores(sim, top_g, torch.isfinite(top_g),
                         fuse_weight=fuse_weight,
                         spatial_weight=spatial_weight,
                         vote_matrix=vote_matrix)
    with record_function("rerank.select"):
        kk = min(k, top_g.shape[1])
        new_s, order = torch.sort(fused, dim=1, descending=True, stable=True)
        new_s, order = new_s[:, :kk], order[:, :kk]
        new_pos = torch.gather(top_pos, 1, order)
        new_ids = torch.where(new_s > float("-inf"),
                              ids[new_pos.clamp(min=0).long()],
                              torch.full_like(new_pos, -1))
    if kk < k:
        new_s = torch.nn.functional.pad(new_s, (0, k - kk),
                                        value=float("-inf"))
        new_ids = torch.nn.functional.pad(new_ids, (0, k - kk), value=-1)
    return new_s, new_ids


def regional_rerank_scores(regional_store: torch.Tensor, ids: torch.Tensor,
                           global_scores: torch.Tensor,
                           query_regional: torch.Tensor, *, depth: int = 100,
                           k: int = 10, fuse_weight: float = 1.0,
                           regional_scales: "torch.Tensor | None" = None):
    """``regional_store [N_pad, R, D]``, ``global_scores [Q, N_pad]``
    (padding already -inf), ``query_regional [Q, Rq, D]`` -> ``(scores [Q,
    k], ids [Q, k])`` re-ordered by fused score: the re-rank oracle over a
    full score matrix, its top-``depth`` (lowest position first on ties)
    re-ranked by :func:`rerank_from_candidates`. The serving composite
    selects the candidates with the fused kernel instead."""
    top_g, top_pos = select_topk(global_scores, depth)
    return rerank_from_candidates(regional_store, ids, top_g, top_pos,
                                  query_regional, k=k,
                                  fuse_weight=fuse_weight,
                                  regional_scales=regional_scales)
