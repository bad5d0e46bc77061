"""Alpha query expansion (port of ``instsearch_tpu/search/qe.py``;
Radenović et al., arXiv:1711.02512 §5):

    q' = l2( q + sum_i  max(s_i, 0)^alpha * x_i ),   i in top-n(q)
"""
from __future__ import annotations

import torch

from .bruteforce import gather_rows_f32, masked_scores, select_topk


def expand_from_candidates(queries: torch.Tensor, top_s: torch.Tensor,
                           neighbors: torch.Tensor, alpha: float = 3.0,
                           include_query: bool = True) -> torch.Tensor:
    """The weighting and normalization: ``queries [Q, D]``, ``top_s [Q, n]``
    (invalid slots -inf), ``neighbors [Q, n, D]`` f32 (invalid rows zeroed)
    -> expanded queries ``[Q, D]`` f32, unit norm. Shared by the oracle
    below, the Index's composite, the sharded expansion and αDBA.

    ``include_query=False`` drops the ``+ q`` term: the database-side
    weighting (αDBA, ``search/dba.py``), where the row is its own top-1
    neighbour at weight 1."""
    q = queries.float()
    w = top_s.clamp(min=0.0) ** alpha                              # [Q, n]
    agg = torch.einsum("qn,qnd->qd", w, neighbors)
    expanded = q + agg if include_query else agg
    norm = torch.linalg.vector_norm(expanded, dim=-1, keepdim=True)
    return expanded / norm.clamp(min=1e-6)


def alpha_query_expansion(descriptors: torch.Tensor, ids: torch.Tensor,
                          queries: torch.Tensor, n: int = 10,
                          alpha: float = 3.0,
                          scales: "torch.Tensor | None" = None,
                          int4: bool = False) -> torch.Tensor:
    """The oracle: ``descriptors [N_pad, D]`` (padding masked by ``ids <
    0``), ``queries [Q, D]`` -> expanded queries ``[Q, D]``. It ranks the
    whole ``[Q, N]`` score matrix of the scoring oracle; the Index's
    composite selects the top-n with the fused kernel instead."""
    q = queries.float()
    top_s, top_pos = select_topk(masked_scores(descriptors, q, scales=scales,
                                               ids=ids, int4=int4), n)
    neighbors = gather_rows_f32(descriptors, top_pos.clamp(min=0), scales,
                                int4=int4)
    neighbors = torch.where((top_s > float("-inf"))[..., None], neighbors,
                            torch.zeros((), device=neighbors.device))
    return expand_from_candidates(q, top_s, neighbors, alpha)
