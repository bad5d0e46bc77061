"""Per-cluster (local) PCA whitening, the expert bank of local-whitening
re-ranking (port of ``instsearch_tpu/ops/local_whiten.py``):

    e(x) = argmax_e <x, centroid_e>        (spherical k-means, ops/kmeans.py)
    out  = L2( P_e (x - mu_e) )

The fit, as the reference's: the rows are sorted by cluster (a stable sort),
then walked in pieces of ``chunk`` sorted rows; each piece adds, for every
cluster it holds, the f32 outer product and the sum of that cluster's rows
to the cluster's moments. A cluster of ``n_e`` members blends
``n_e / (n_e + tau)`` of its own mean and covariance with the rest from the
global ones (the sums of the per-cluster moments), so a small cluster falls
back to the global whitening and ``tau = inf`` is exactly it. Each
projection comes from an ``eigh`` of the blended covariance, as
``ops/whitening.py::fit_whitening`` builds the global one (in float64, the
covariance accumulated in f32), BANK_PIECE clusters at a time to bound the
f64 copy (a 2048 x 2048 f64 ``eigh`` takes ~28 ms on an H100, f32 ~26 ms:
``chip_smoke.py`` phase 11b).

The sign of an eigenvector (and the basis of a repeated eigenvalue) is
LAPACK's or cuSOLVER's choice, so ``P`` is comparable between the packages
only through what it scores: ``<P_e(q - mu_e), P_e(x - mu_e)>``, or
``P_e^T P_e``.

Projections of many rows are grouped by expert, one product per expert
present, so no ``[B, dim, D]`` gather of the bank is ever made.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .kmeans import fit_kmeans
from .pooling import l2_normalize

BANK_PIECE = 16     # clusters whose covariances go through one eigh call


class LocalWhiteningParams(NamedTuple):
    """A fitted expert bank: route by ``centroids``, then ``apply_e(x) =
    P[e] @ (x - mu[e])``."""

    centroids: torch.Tensor   # [E, D] f32 unit-norm router codebook
    P: torch.Tensor           # [E, dim, D] f32 per-cluster projections
    mu: torch.Tensor          # [E, D] f32 per-cluster means


def cluster_moments(x: torch.Tensor, assign: torch.Tensor, n_clusters: int,
                    chunk: int = 16384):
    """Per-cluster moments of rows ``x [n, D]`` with cluster ids ``assign
    [n]`` -> ``(outer [E, D, D], sums [E, D], counts [E])`` f32. Rows are
    sorted by cluster (stable), then each piece of ``chunk`` sorted rows
    adds each of its clusters' outer product and row sum."""
    n, d = x.shape
    dev = x.device
    order = torch.argsort(assign, stable=True)
    xs = x.float()[order]
    asort = assign[order].long()
    outer = torch.zeros((n_clusters, d, d), dtype=torch.float32, device=dev)
    sums = torch.zeros((n_clusters, d), dtype=torch.float32, device=dev)
    counts = torch.zeros((n_clusters,), dtype=torch.float32, device=dev)
    for c0 in range(0, n, chunk):
        ac = asort[c0:c0 + chunk]
        xc = xs[c0:c0 + chunk]
        eids, lens = torch.unique_consecutive(ac, return_counts=True)
        s = 0
        for e, m in zip(eids.tolist(), lens.tolist()):
            seg = xc[s:s + m]
            outer[e] += seg.T @ seg
            sums[e] += seg.sum(dim=0)
            counts[e] += m
            s += m
    return outer, sums, counts


def bank_from_moments(outer: torch.Tensor, sums: torch.Tensor,
                      counts: torch.Tensor, *, dim: int, tau: float = 64.0,
                      shrinkage: float = 0.0, eps: float = 1e-9):
    """Blend the per-cluster moments toward the global ones and build the
    bank -> ``(P [E, dim, D], mu [E, D])`` f32. The global moments are the
    sums of the per-cluster ones."""
    e_count, d = sums.shape
    n_g = counts.sum()
    g_mu = sums.sum(0) / n_g.clamp(min=1.0)
    g_cov = ((outer.sum(0) - n_g * torch.outer(g_mu, g_mu))
             / (n_g - 1.0).clamp(min=1.0))
    P = torch.empty((e_count, dim, d), dtype=torch.float32,
                    device=sums.device)
    mus = torch.empty((e_count, d), dtype=torch.float32, device=sums.device)
    eye = torch.eye(d, dtype=torch.float32, device=sums.device)
    for e0 in range(0, e_count, BANK_PIECE):
        sl = slice(e0, e0 + BANK_PIECE)
        n = counts[sl, None]                                     # [e, 1]
        mu = sums[sl] / n.clamp(min=1.0)                         # [e, D]
        cov = ((outer[sl] - n[..., None] * mu[:, :, None] * mu[:, None, :])
               / (n[..., None] - 1.0).clamp(min=1.0))            # [e, D, D]
        w = (counts[sl] / (counts[sl] + tau))[:, None]           # [e, 1]
        mus[sl] = w * mu + (1.0 - w) * g_mu
        cov = w[..., None] * cov + (1.0 - w[..., None]) * g_cov
        if shrinkage > 0.0:
            tr = torch.diagonal(cov, dim1=-2, dim2=-1).sum(-1)[:, None, None]
            cov = (1.0 - shrinkage) * cov + shrinkage * eye * tr / d
        evals, evecs = torch.linalg.eigh(cov.double())           # ascending
        evals = evals.flip(-1)[:, :dim]                          # [e, dim]
        evecs = evecs.flip(-1)[:, :, :dim]                       # [e, D, dim]
        P[sl] = (evecs * torch.rsqrt(evals.clamp(min=eps))[:, None, :]
                 ).transpose(1, 2).float()
    return P, mus


def fit_local_whitening(X: torch.Tensor, n_clusters: int, *,
                        dim: "int | None" = None, tau: float = 64.0,
                        shrinkage: float = 0.0,
                        num_valid: "int | None" = None, iters: int = 10,
                        seed: int = 0, chunk: int = 16384,
                        eps: float = 1e-9) -> LocalWhiteningParams:
    """Fit an ``n_clusters``-expert bank on ``X [N, D]`` (rows at or past
    ``num_valid`` are padding), on ``X``'s device. ``dim`` keeps the
    leading components, at most ``num_valid - 1``."""
    X = X.float()
    n, d = X.shape
    nv = int(num_valid if num_valid is not None else n)
    dim_out = d if dim in (None, 0) else min(dim, d)
    dim_out = min(dim_out, max(nv - 1, 1))
    centroids, assign = fit_kmeans(X, n_clusters, num_valid=nv, iters=iters,
                                   seed=seed)
    outer, sums, counts = cluster_moments(X[:nv], assign[:nv], n_clusters,
                                          chunk=min(chunk, nv))
    P, mu = bank_from_moments(outer, sums, counts, dim=dim_out, tau=tau,
                              shrinkage=shrinkage, eps=eps)
    return LocalWhiteningParams(centroids=centroids, P=P, mu=mu)


def route(x: torch.Tensor, params: LocalWhiteningParams) -> torch.Tensor:
    """Nearest-centroid expert of each row: ``x [..., D] -> [...]`` int64
    (f32 scores, ties to the lowest expert)."""
    return (x.float() @ params.centroids.T).argmax(dim=-1)


def project_by_expert(x: torch.Tensor, experts: torch.Tensor,
                      P: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    """``P[e] @ (x - mu[e])`` for each row with ``e = experts[row]`` (ids
    into ``P``/``mu``; rows with an id outside them come back zero) ->
    ``[B, dim]`` f32: one product per expert present."""
    out = x.new_zeros((x.shape[0], P.shape[1]), dtype=torch.float32)
    ok = (experts >= 0) & (experts < P.shape[0])
    if not bool(ok.any()):
        return out
    order = torch.argsort(torch.where(ok, experts, P.shape[0]), stable=True)
    order = order[:int(ok.sum())]
    eids, lens = torch.unique_consecutive(experts[order], return_counts=True)
    s = 0
    xf = x.float()
    for e, m in zip(eids.tolist(), lens.tolist()):
        rows = order[s:s + m]
        out[rows] = (xf[rows] - mu[e]) @ P[e].T
        s += m
    return out


def apply_local_whitening(x: torch.Tensor, params: LocalWhiteningParams,
                          renormalize: bool = True) -> torch.Tensor:
    """Route and whiten: ``x [B, D] -> [B, dim]`` f32."""
    out = project_by_expert(x, route(x, params), params.P, params.mu)
    return l2_normalize(out, axis=-1) if renormalize else out
