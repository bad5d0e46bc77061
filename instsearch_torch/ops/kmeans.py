"""Spherical k-means (port of ``instsearch_tpu/ops/kmeans.py``): the router
of local whitening (``ops/local_whiten.py``), and the coarse quantizer the
IVF tier will take.

Lloyd's algorithm as two products a piece of rows: the assignment is the
argmax over ``X @ C.T`` with both operands in bf16 and the sums in f32 (the
reference's ``preferred_element_type=f32``: bf16 products are exact in
f32), and the accumulation is ``onehot(assign).T @ X`` in the same
precision. Descriptors are unit-norm, so centroids are re-normalized every
iteration; an empty cluster keeps its centroid for the iteration and the
host respawns it on a random valid row.

The initial rows and the respawns come from ``numpy.random.default_rng(
seed)`` exactly as in the reference, so both packages start from the same
centroids. Rows go through in pieces of ``chunk``; unlike the reference, a
piece need not divide the rows (the last one is shorter): only the order of
the f32 sums across pieces differs.
"""
from __future__ import annotations

import numpy as np
import torch


def pick_chunk(n: int, want: int = 16384) -> int:
    """Largest divisor of ``n`` that is <= ``want``: the fits and encoders
    walk the rows in equal slices of this many rows, as the reference does."""
    c = min(want, n)
    while n % c:
        c -= 1
    return c


def _l2n(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1,
                                        keepdim=True).clamp(min=eps)


def _scores(xc: torch.Tensor, cb: torch.Tensor) -> torch.Tensor:
    """``[chunk, C]`` f32 sums of bf16 products: ``cb`` is the bf16
    codebook widened to f32."""
    return xc.to(torch.bfloat16).float() @ cb.T


def _codebook(centroids: torch.Tensor) -> torch.Tensor:
    return centroids.to(torch.bfloat16).float()


def assign_clusters(x: torch.Tensor, centroids: torch.Tensor,
                    num_valid: "int | None" = None, *,
                    chunk: int = 16384) -> torch.Tensor:
    """Nearest-centroid assignment: ``x [N, D]`` -> ``[N]`` int32 on
    ``x``'s device, -1 for rows at or past ``num_valid``. Ties go to the
    lowest centroid."""
    n = x.shape[0]
    nv = n if num_valid is None else int(num_valid)
    cb = _codebook(centroids.to(x.device))
    out = torch.full((n,), -1, dtype=torch.int32, device=x.device)
    for s in range(0, nv, chunk):
        xc = x[s:min(s + chunk, nv)]
        out[s:s + xc.shape[0]] = _scores(xc, cb).argmax(dim=1).to(torch.int32)
    return out


def lloyd_iter(x: torch.Tensor, centroids: torch.Tensor,
               num_valid: "int | None" = None, *, chunk: int = 16384):
    """One Lloyd iteration -> ``(centroids [C, D] f32 unit-norm, counts
    [C] int64, mean cosine of each valid row to its centroid)``; an empty
    cluster keeps its previous centroid."""
    n, d = x.shape
    nv = n if num_valid is None else int(num_valid)
    c = centroids.shape[0]
    cb = _codebook(centroids)
    sums = torch.zeros((c, d), dtype=torch.float32, device=x.device)
    counts = torch.zeros((c,), dtype=torch.int64, device=x.device)
    simsum = torch.zeros((), dtype=torch.float32, device=x.device)
    for s in range(0, nv, chunk):
        xf = x[s:min(s + chunk, nv)].to(torch.bfloat16).float()
        best, a = _scores(xf, cb).max(dim=1)
        onehot = torch.nn.functional.one_hot(a, c).float()      # [chunk, C]
        sums += onehot.T @ xf
        counts += torch.bincount(a, minlength=c)
        simsum += best.sum()
    new = torch.where(counts[:, None] > 0, _l2n(sums), centroids)
    return new, counts, simsum / max(nv, 1)


def fit_kmeans(x: torch.Tensor, n_clusters: int, *,
               num_valid: "int | None" = None, iters: int = 10,
               seed: int = 0, chunk: int = 16384,
               respawn_empty: bool = True):
    """Spherical k-means over ``x [N, D]`` (rows at or past ``num_valid``
    are padding) -> ``(centroids [C, D] f32 unit-norm, assignments [N]
    int32, -1 for padding)``, on ``x``'s device. Init: ``n_clusters``
    distinct valid rows drawn by ``default_rng(seed)``; empty clusters
    respawn on rows drawn by the same generator, as the reference."""
    n = x.shape[0]
    nv = int(num_valid if num_valid is not None else n)
    if nv < n_clusters:
        raise ValueError(f"{nv} rows < {n_clusters} clusters")
    x = x.float()
    rng = np.random.default_rng(seed)

    def rows(pick) -> torch.Tensor:
        return _l2n(x[torch.as_tensor(pick, device=x.device)])

    cent = rows(rng.choice(nv, size=n_clusters, replace=False))
    for _ in range(iters):
        cent, counts, _ = lloyd_iter(x, cent, nv, chunk=chunk)
        if respawn_empty:
            empty = np.flatnonzero(counts.cpu().numpy() == 0)
            if len(empty):
                cent[torch.as_tensor(empty, device=x.device)] = rows(
                    rng.choice(nv, size=len(empty), replace=False))
    return cent, assign_clusters(x, cent, nv, chunk=chunk)
