"""Diffusion re-ranking on the candidate similarity graph (port of
``instsearch_tpu/search/diffusion.py``; Iscen et al., "Efficient Diffusion
on Region Manifolds", CVPR 2017, arXiv:1611.05113, truncated form §4.3):

1. candidates: the top-``L`` rows by global cosine (the fused top-k kernel
   in the Index's composite, a full ranking in the oracle);
2. graph: the mutual-``knn`` affinity ``A_ij = relu(v_i . v_j)^3`` over the
   gathered candidate vectors (a batched ``[Q, L, L]`` product),
   symmetrically normalized, ``W = D^-1/2 A D^-1/2``;
3. seeds: ``y_i = relu(g_i)^3`` for the ``seeds`` best candidates;
4. ``(I - alpha W) f = y`` solved by ``iters`` conjugate-gradient steps, a
   fixed count;
5. the candidates re-ranked by ``f``.

Invalid candidate slots (global score -inf) are cut out of the graph,
seeded 0 and come back -inf. Candidates no seed reaches get ``f = 0``; a
``1e-4 * g`` term keeps their global order. Everything here is plain
PyTorch in f32: the reference computes it outside any Pallas kernel. The
products must not run in TF32 on the card (PyTorch's default keeps f32).
"""
from __future__ import annotations

import torch

from .bruteforce import gather_rows_f32, select_topk

_NEG = float("-inf")


def mutual_knn_affinity(v: torch.Tensor, valid: torch.Tensor, knn: int,
                        gamma: float = 3.0) -> torch.Tensor:
    """``v [Q, L, D]`` unit rows, ``valid [Q, L]`` bool -> the symmetrically
    normalized mutual-``knn`` affinity ``W [Q, L, L]``. A row keeps the
    edges at or above its ``knn``-th largest affinity (ties may keep a few
    more, as in the reference)."""
    sim = torch.bmm(v, v.transpose(1, 2))                        # [Q, L, L]
    l = v.shape[1]
    eye = torch.eye(l, dtype=torch.bool, device=v.device)
    ok = valid[:, :, None] & valid[:, None, :] & ~eye
    zero = torch.zeros((), device=v.device)
    a = torch.where(ok, sim.clamp(min=0.0) ** gamma, zero)
    kk = min(knn, l - 1) if l > 1 else 1
    thresh = torch.topk(a, kk, dim=-1).values[..., -1:]          # [Q, L, 1]
    keep = (a >= thresh.clamp(min=1e-12)) & ok
    keep = keep & keep.transpose(1, 2)                           # mutual
    a = torch.where(keep, a, zero)
    a = 0.5 * (a + a.transpose(1, 2))                            # symmetric
    dinv = torch.rsqrt(a.sum(dim=-1).clamp(min=1e-12))           # [Q, L]
    return a * dinv[:, :, None] * dinv[:, None, :]


def cg_solve(w: torch.Tensor, y: torch.Tensor, alpha: float,
             iters: int) -> torch.Tensor:
    """Batched conjugate gradients for ``(I - alpha W) f = y``: ``w [Q, L,
    L]``, ``y [Q, L]`` -> ``f [Q, L]`` after ``iters`` steps from ``f =
    y``."""
    def apply_a(x):
        return x - alpha * torch.bmm(w, x[:, :, None])[:, :, 0]

    def dot(a, b):
        return (a * b).sum(dim=-1, keepdim=True)                 # [Q, 1]

    x = y
    r = y - apply_a(x)
    p = r
    rs = dot(r, r)
    for _ in range(iters):
        ap = apply_a(p)
        a = rs / dot(p, ap).clamp(min=1e-20)
        x = x + a * p
        r = r - a * ap
        rs_new = dot(r, r)
        p = r + (rs_new / rs.clamp(min=1e-20)) * p
        rs = rs_new
    return x


def diffuse_from_candidates(cand: torch.Tensor, top_g: torch.Tensor, *,
                            knn: int = 10, alpha: float = 0.99,
                            iters: int = 20, seeds: int = 10) -> torch.Tensor:
    """Diffused scores of pre-selected candidates: ``cand [Q, L, D]`` their
    vectors (invalid rows anything), ``top_g [Q, L]`` their global cosine
    (invalid slots -inf) -> ``f [Q, L]``, -inf at invalid slots. Shared by
    the oracle, the Index's composite and the sharded stage."""
    valid = top_g > _NEG
    zero = torch.zeros((), device=cand.device)
    v = torch.where(valid[..., None], cand.float(), zero)
    w = mutual_knn_affinity(v, valid, knn)
    g = torch.where(valid, top_g, zero)
    ss = min(seeds, top_g.shape[1])
    thresh = torch.topk(g, ss, dim=1).values[:, -1:]             # [Q, 1]
    y = torch.where(valid & (g >= thresh), g.clamp(min=0.0) ** 3, zero)
    f = cg_solve(w, y, alpha, iters) + 1e-4 * g
    return torch.where(valid, f, torch.full_like(f, _NEG))


def diffusion_rerank_from_candidates(ids: torch.Tensor, top_g: torch.Tensor,
                                     top_pos: torch.Tensor,
                                     cand: torch.Tensor, *, k: int = 10,
                                     knn: int = 10, alpha: float = 0.99,
                                     iters: int = 20, seeds: int = 10):
    """Re-rank candidates by diffusion: ``top_g``/``top_pos [Q, L]`` from
    any top-L selection (positions into ``ids``) and ``cand [Q, L, D]``
    their rows -> ``(scores [Q, k], dataset ids [Q, k])``; slots past ``L``
    are ``(-inf, -1)``. Ties keep the lowest candidate slot first."""
    f = diffuse_from_candidates(cand, top_g, knn=knn, alpha=alpha,
                                iters=iters, seeds=seeds)
    s, order = select_topk(f, k)
    pos = torch.take_along_dim(top_pos.long(), order.clamp(min=0).long(), 1)
    out = torch.where(s > _NEG, ids[pos.clamp(min=0)].to(torch.int32),
                      torch.full_like(order, -1))
    return s, out


def diffusion_rerank_scores(descriptors: torch.Tensor, ids: torch.Tensor,
                            global_scores: torch.Tensor, *, depth: int = 200,
                            k: int = 10, knn: int = 10, alpha: float = 0.99,
                            iters: int = 20, seeds: int = 10,
                            scales: "torch.Tensor | None" = None):
    """The oracle over a full ``[Q, N]`` score matrix (padding already
    -inf): the top-``depth`` selected by a full ranking, their rows gathered
    and dequantized, diffused and re-ranked. The Index's composite selects
    the candidates with the fused kernel instead."""
    top_g, top_pos = select_topk(global_scores, depth)
    cand = gather_rows_f32(descriptors, top_pos.clamp(min=0), scales)
    return diffusion_rerank_from_candidates(
        ids, top_g, top_pos, cand, k=k, knn=knn, alpha=alpha, iters=iters,
        seeds=seeds)
