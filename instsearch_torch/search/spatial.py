"""Spatial verification for regional re-ranking (port of
``instsearch_tpu/search/spatial.py``): weak geometric consistency by Hough
voting over region-pair transform hypotheses.

Every (query region i, candidate region j) pair implies a transform
``(dx, dy, dlog s)`` from the R-MAC grid's geometry, a constant of the
configuration (``ops/pooling.py::rmac_region_geometry``). The host
quantizes it into a coarse 3-D histogram once, a one-hot ``V [Rq*Rc,
bins]``; at query time the re-rank stage's similarities vote with weight
``relu(sim)``, one product with ``V``, and the spatial score is the best
bin: the similarity mass one consistent transform explains.
"""
from __future__ import annotations

import numpy as np
import torch


def build_vote_matrix(geom_q: np.ndarray, geom_c: np.ndarray,
                      bins_xy: int = 5, bins_scale: int = 3) -> np.ndarray:
    """One-hot transform-bin assignment ``[Rq*Rc, B]`` (f32, on the host).
    ``geom_* [R, 3]`` rows are ``(cx, cy, log side)`` in map coordinates.
    Translations are normalized by the map's extent; scale changes are
    binned over their own range."""
    gq = np.asarray(geom_q, np.float32)
    gc = np.asarray(geom_c, np.float32)
    extent = max(
        float(np.ptp(gq[:, 0]) + np.ptp(gc[:, 0])),
        float(np.ptp(gq[:, 1]) + np.ptp(gc[:, 1])), 1.0)
    dx = (gc[None, :, 0] - gq[:, None, 0]) / extent          # [Rq, Rc]
    dy = (gc[None, :, 1] - gq[:, None, 1]) / extent
    ds = gc[None, :, 2] - gq[:, None, 2]

    def q(v, n, lo, hi):
        return np.clip(((v - lo) / (hi - lo) * n).astype(np.int64), 0, n - 1)

    bx = q(dx, bins_xy, -0.55, 0.55)
    by = q(dy, bins_xy, -0.55, 0.55)
    smax = max(float(np.abs(ds).max()), 1e-3)
    bs = q(ds, bins_scale, -1.001 * smax, 1.001 * smax)
    flat = (bx * bins_xy + by) * bins_scale + bs             # [Rq, Rc]
    b = bins_xy * bins_xy * bins_scale
    v = np.zeros((gq.shape[0] * gc.shape[0], b), np.float32)
    v[np.arange(v.shape[0]), flat.reshape(-1)] = 1.0
    return v


def spatial_consistency_scores(sim: torch.Tensor,
                               vote_matrix: torch.Tensor) -> torch.Tensor:
    """``sim [Q, depth, Rq, Rc]`` -> ``[Q, depth]``: the largest single-bin
    vote mass, divided by the query's region count (the region match's
    normalization)."""
    qn, d, rq, rc = sim.shape
    w = sim.clamp(min=0.0).reshape(qn, d, rq * rc)
    return (w @ vote_matrix).amax(dim=-1) / rq
