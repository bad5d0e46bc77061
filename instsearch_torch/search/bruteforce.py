"""Brute-force cosine top-k, the plain scoring path (port of
``instsearch_tpu/search/bruteforce.py``: ``masked_scores`` and
``search_topk``; float stores only).

This is the scoring oracle of the port and the basis of the fused kernel's
plain version (``kernels/topk_matmul.py::topk_matmul_reference``). int8/int4
stores raise until ROADMAP M1 / Queue 2 K2-K3.
"""
from __future__ import annotations

import torch


def masked_scores(descriptors: torch.Tensor, queries: torch.Tensor,
                  ids: "torch.Tensor | None" = None) -> torch.Tensor:
    """[Q, N] f32 scores of queries cast to the store's dtype. Both operands
    go to f32 before the product: a bf16 matmul would return bf16 scores,
    while bf16 x bf16 products are exact in f32. Padding rows (id -1) are
    masked to -inf when ``ids`` is given."""
    if descriptors.dtype not in (torch.bfloat16, torch.float32):
        raise NotImplementedError(
            f"{descriptors.dtype} stores are not ported yet (ROADMAP M1)")
    scores = (queries.to(descriptors.dtype).float()
              @ descriptors.float().T)
    if ids is not None:
        scores = scores.masked_fill(ids[None, :] < 0, float("-inf"))
    return scores


def select_topk(scores: torch.Tensor, k: int):
    """Top-k of [Q, N] scores -> ``(scores [Q, k], positions [Q, k] int32)``.
    A stable descending sort puts the lowest position first among ties, as
    ``lax.top_k`` does (``torch.topk`` promises no order). Slots scoring
    -inf, and slots past N when k > N, come back as ``(-inf, -1)``."""
    s, i = torch.sort(scores, dim=1, descending=True, stable=True)
    s, i = s[:, :k], i[:, :k].to(torch.int32)
    i = torch.where(s > float("-inf"), i, torch.full_like(i, -1))
    if s.shape[1] < k:
        pad = k - s.shape[1]
        s = torch.cat([s, s.new_full((s.shape[0], pad), float("-inf"))], 1)
        i = torch.cat([i, i.new_full((i.shape[0], pad), -1)], 1)
    return s, i


def search_topk(index: torch.Tensor, queries: torch.Tensor, k: int = 10,
                ids: "torch.Tensor | None" = None):
    """``index [N, D]``, ``queries [Q, D]`` -> ``(scores [Q, k], positions
    [Q, k])``; pass ``ids`` when the store carries padding rows (id -1)."""
    return select_topk(masked_scores(index, queries, ids=ids), k)
