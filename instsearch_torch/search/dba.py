"""Database-side augmentation, αDBA (port of ``instsearch_tpu/search/dba.py``;
Arandjelović & Zisserman, CVPR 2012, with the αQE weighting of Radenović et
al., arXiv:1711.02512 §5):

    x_i' = l2( sum_{j in top-n(x_i)}  max(s_ij, 0)^alpha * x_j )

where the top-n of a row includes the row itself (self-similarity 1, weight
1). This module holds the full-matrix oracle; the production pass is
``Index.augment_database``, which selects the neighbours chunk by chunk
through the fused top-k kernels and shares
``qe.expand_from_candidates(include_query=False)``.
"""
from __future__ import annotations

import torch

from .bruteforce import masked_scores, select_topk
from .qe import expand_from_candidates


def dba_augment(descriptors: torch.Tensor, ids: torch.Tensor, n: int = 10,
                alpha: float = 3.0,
                scales: "torch.Tensor | None" = None) -> torch.Tensor:
    """The oracle: ``descriptors [N_pad, D]`` float or int8 (with ``scales
    [1, N_pad]``; padding rows id -1) -> augmented rows ``[N_pad, D]`` f32,
    padding rows zero. It ranks the whole ``[N, N]`` self-similarity matrix,
    for tests and small stores."""
    x = descriptors.float()
    if descriptors.dtype == torch.int8:
        x = x * scales.reshape(-1, 1)
    top_s, top_pos = select_topk(masked_scores(descriptors, x, scales=scales,
                                               ids=ids), n)
    neighbors = x[top_pos.clamp(min=0).long()]                   # [N, n, D]
    neighbors = torch.where((top_s > float("-inf"))[..., None], neighbors,
                            torch.zeros((), device=x.device))
    out = expand_from_candidates(x, top_s, neighbors, alpha,
                                 include_query=False)
    return torch.where((ids >= 0)[:, None], out,
                       torch.zeros((), device=out.device))
