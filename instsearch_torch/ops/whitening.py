"""PCA-whitening of descriptors (port of ``instsearch_tpu/ops/whitening.py``:
``fit_whitening``, ``fit_lw_whitening``, ``apply_whitening`` and
``apply_whitening_regional``).

The fit takes the eigendecomposition of the D x D covariance with
``torch.linalg.eigh`` in float64 (the covariance is accumulated in f32, as
in the reference, then widened): the reference's f32 ``eigh`` and this one
agree on the leading subspace, and f64 keeps the small eigenvalues that
``rsqrt`` amplifies from losing their digits. ``P`` and ``mu`` come back in
f32.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .pooling import l2_normalize


class WhiteningParams(NamedTuple):
    """Fitted whitening: ``apply(x) = P @ (x - mu)``."""

    P: torch.Tensor     # [dim_out, D] projection (rows scaled by lambda^-1/2)
    mu: torch.Tensor    # [D] mean


def fit_whitening(X: torch.Tensor, dim: int | None = None,
                  shrinkage: float = 0.0, eps: float = 1e-9) -> WhiteningParams:
    """Fit PCA-whitening on descriptors ``X: [N, D]``. ``dim`` keeps the
    leading components, clamped to ``min(dim, D, N - 1)`` (PCA estimates at
    most N-1 directions; keeping rank-deficient ones would amplify noise by
    ``eps ** -0.5``). ``shrinkage`` blends the covariance toward the
    identity. Eigen-order is descending."""
    X = X.float()
    n, d = X.shape
    dim = d if dim in (None, 0) else min(dim, d)
    dim = min(dim, max(n - 1, 1))
    mu = X.mean(dim=0)
    Xc = X - mu
    cov = (Xc.T @ Xc) / max(n - 1, 1)
    if shrinkage > 0.0:
        eye = torch.eye(d, dtype=cov.dtype, device=cov.device)
        cov = (1.0 - shrinkage) * cov + shrinkage * eye * torch.trace(cov) / d
    evals, evecs = torch.linalg.eigh(cov.double())      # ascending
    evals = evals.flip(0)[:dim]
    evecs = evecs.flip(1)[:, :dim]
    P = (evecs * torch.rsqrt(torch.clamp(evals, min=eps))).T
    return WhiteningParams(P=P.float().contiguous(), mu=mu)


def fit_lw_whitening(anchors: torch.Tensor, positives: torch.Tensor,
                     dim: int | None = None,
                     eps: float = 1e-9) -> WhiteningParams:
    """Learned discriminative (Lw) whitening (arXiv:1711.02512 §3.4) of
    matched pairs ``anchors``/``positives: [M, D]``: whiten by the
    within-pair scatter ``C_S = mean_i (a_i - p_i)(a_i - p_i)^T`` (its
    inverse square root, eigenvalues floored at ``max(eig) * 1e-4`` so
    unobserved directions are amplified boundedly), then rotate by the PCA
    of the projected anchors, keeping ``min(dim, D, M - 1)`` components.
    Both eigendecompositions are f32, as the reference's; ``P`` is defined
    up to the sign of each row."""
    a = anchors.float()
    p = positives.float()
    m, d = a.shape
    dim = d if dim in (None, 0) else min(dim, d)
    dim = min(dim, max(m - 1, 1))
    diff = a - p
    cs = (diff.T @ diff) / max(m, 1)
    s_evals, s_evecs = torch.linalg.eigh(cs)
    floor = torch.clamp(torch.max(s_evals) * 1e-4, min=eps)
    inv_sqrt = (s_evecs * torch.rsqrt(torch.maximum(s_evals, floor))
                ) @ s_evecs.T                                   # [D, D]
    mu = a.mean(dim=0)
    proj = (a - mu) @ inv_sqrt.T
    cov = (proj.T @ proj) / max(m - 1, 1)
    _, r_evecs = torch.linalg.eigh(cov)                         # ascending
    rot = r_evecs.flip(1)[:, :dim]                              # top-dim PCA
    return WhiteningParams(P=(rot.T @ inv_sqrt).contiguous(), mu=mu)


def apply_whitening(x: torch.Tensor, params: WhiteningParams,
                    renormalize: bool = True) -> torch.Tensor:
    """Whiten ``x: [..., D] -> [..., dim]`` in f32 and re-L2."""
    out = (x.float() - params.mu) @ params.P.T
    if renormalize:
        out = l2_normalize(out, dim=-1)
    return out


def apply_whitening_regional(reg, params: WhiteningParams,
                             chunk: int = 65536) -> torch.Tensor:
    """Whiten regional rows ``[N, R, D]`` (numpy, or a tensor on any
    device) -> f32 ``[N, R, dim]`` on the device of ``params``, re-L2'd per
    region. The store is R x the index, the system's largest tensor, so the
    N*R rows move to the device and through the projection ``chunk`` rows
    at a time: the chunk bounds the working memory beside the output."""
    reg = torch.as_tensor(reg)
    n, r, d = reg.shape
    flat = reg.reshape(-1, d)
    out = torch.empty((flat.shape[0], params.P.shape[0]),
                      dtype=torch.float32, device=params.P.device)
    for i in range(0, flat.shape[0], chunk):
        out[i:i + chunk] = apply_whitening(
            flat[i:i + chunk].to(params.P.device), params)
    return out.reshape(n, r, -1)
