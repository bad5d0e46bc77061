"""Local-whitening re-ranking (port of ``instsearch_tpu/search/lw_rerank.py``):
the top-depth candidates re-scored under each candidate's own cluster
metric,

    s(q, c) = < L2(P_e(q - mu_e)), L2(P_e(x_c - mu_e)) >,  e = cluster(c),

both sides always whitened by the same expert (``ops/local_whiten.py``).
Every stored row is kept whitened by its own cluster in a position-aligned
``[N_pad, dim]`` bf16 store with its ``[N_pad]`` cluster ids; at query time
the (post-QE) query is whitened by all E experts at once (one batched
product over the bank), and each candidate's score is a gather and a dot
product. Plain PyTorch in f32 (no TF32 on the card): the reference computes
this stage outside any Pallas kernel.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..ops.local_whiten import (LocalWhiteningParams, apply_local_whitening,
                                fit_local_whitening, route)
from ..ops.pooling import l2_normalize
from ..utils.device import resolve_device
from .bruteforce import select_topk

_NEG = float("-inf")


def whiten_all_clusters(q: torch.Tensor, P: torch.Tensor,
                        mu: torch.Tensor) -> torch.Tensor:
    """Whiten queries by every expert: ``q [B, D] -> [B, E, dim]`` f32,
    L2-normalized per (query, expert); one batched product over the
    bank."""
    xm = q.float()[:, None, :] - mu[None]                        # [B, E, D]
    out = torch.einsum("bed,eod->beo", xm, P)                    # [B, E, dim]
    return l2_normalize(out, dim=-1)


def lw_rescore_from_candidates(store, assign, ids, cand_scores, pos, q_all,
                               *, k: int):
    """Re-score candidates under their own cluster's metric: ``store
    [N_pad, dim]`` whitened rows, ``assign [N_pad]`` their clusters, ``pos
    [B, depth]`` candidate positions (-1 empty), ``cand_scores`` their global
    scores (-inf empty), ``q_all [B, E, dim]`` -> ``(scores [B, k], dataset
    ids [B, k])``, ties to the lowest candidate slot."""
    s = lw_candidate_scores(store, assign, pos, q_all)
    s = torch.where((cand_scores > _NEG) & (pos >= 0), s,
                    torch.full_like(s, _NEG))
    top_s, j = select_topk(s, k)
    top_pos = torch.take_along_dim(pos.long(), j.clamp(min=0).long(), 1)
    out = torch.where(top_s > _NEG, ids[top_pos.clamp(min=0)].to(torch.int32),
                      torch.full_like(j, -1))
    return top_s, out


def lw_candidate_scores(store, assign, pos, q_all) -> torch.Tensor:
    """``[B, depth]`` f32 scores of the rows at ``pos`` (clamped to 0)
    against the query whitened by each row's own cluster."""
    safe = pos.clamp(min=0).long()
    xw = store[safe].float()                                     # [B, d, dim]
    ac = assign[safe].long()                                     # [B, d]
    qw = torch.take_along_dim(q_all, ac[:, :, None], 1)          # [B, d, dim]
    return (qw * xw).sum(dim=-1)


class LocalWhiteningView:
    """The fitted bank and the whitened row store, attached to an Index.
    ``add`` is absorbed (:meth:`absorb_add`: new rows routed and whitened
    under the frozen bank), ``remove`` too (:meth:`absorb_remove` replays
    the compaction moves); αDBA drops the view."""

    def __init__(self, params: LocalWhiteningParams, store: torch.Tensor,
                 assign: torch.Tensor):
        self.params = params     # router + bank (centroids, P, mu)
        self.store = store       # [N_pad, dim] bf16, each row whitened by
        #                          its own cluster, L2-normalized
        self.assign = assign     # [N_pad] int32 cluster of each row (0 pad)

    @property
    def n_clusters(self) -> int:
        return self.params.P.shape[0]

    @property
    def dim(self) -> int:
        return self.store.shape[1]

    # ------------------------------------------------------------------
    @classmethod
    def from_index(cls, index, n_clusters: "int | None" = None,
                   dim: "int | None" = None, tau: float = 64.0,
                   iters: int = 10, seed: int = 0,
                   chunk: int = 65536) -> "LocalWhiteningView":
        """Fit the bank on the index's valid rows (dequantized, without the
        store's zero columns) and whiten every one into the store, on the
        index's device. ``n_clusters`` defaults to ~sqrt(N) as a power of
        two."""
        nv = index.num_valid
        if nv < 2:
            raise ValueError("local whitening needs at least 2 indexed rows")
        if n_clusters is None:
            n_clusters = max(2, 1 << int(round(np.log2(max(2, np.sqrt(nv))))))
        n_clusters = min(n_clusters, nv)
        n_pad = index.n_pad
        xf = index._rows_f32_chunk(0, nv)
        params = fit_local_whitening(xf, n_clusters, dim=dim, tau=tau,
                                     iters=iters, seed=seed)
        store = torch.zeros((n_pad, params.P.shape[1]), dtype=torch.bfloat16,
                            device=index.device)
        assign = torch.zeros((n_pad,), dtype=torch.int32, device=index.device)
        for s0 in range(0, nv, chunk):
            rows = xf[s0:s0 + chunk]
            assign[s0:s0 + rows.shape[0]] = route(rows, params).to(
                torch.int32)
            store[s0:s0 + rows.shape[0]] = apply_local_whitening(
                rows, params).to(torch.bfloat16)
        return cls(params, store, assign)

    # ------------------------------------------------------------------
    def absorb_add(self, index, start: int, n_new: int) -> None:
        """Route and whiten the rows ``[start, start + n_new)`` just written
        to the main store under the frozen bank, into the position-aligned
        store (grown first when the add re-padded the main store). The
        reference's window: the next power of two at least ``n_new`` (at
        least 8) rows from ``start``, moved back when it would run past the
        store, all written, so the stores stay the reference's."""
        n_pad = index.n_pad
        if self.store.shape[0] != n_pad:
            grow = n_pad - self.store.shape[0]
            self.store = torch.cat([self.store, self.store.new_zeros(
                (grow, self.store.shape[1]))])
            self.assign = torch.cat([self.assign,
                                     self.assign.new_zeros((grow,))])
        p = max(8, 1 << max(0, n_new - 1).bit_length())
        s0 = 0 if p >= n_pad else min(start, n_pad - p)
        rows = index._rows_f32_chunk(s0, min(p, n_pad))
        self.store[s0:s0 + rows.shape[0]] = apply_local_whitening(
            rows, self.params).to(self.store.dtype)
        self.assign[s0:s0 + rows.shape[0]] = route(rows, self.params).to(
            torch.int32)

    def absorb_remove(self, src: torch.Tensor, dst: torch.Tensor) -> None:
        """Replay ``Index.remove``'s compaction moves on the store and the
        cluster ids."""
        self.store[dst] = self.store[src]
        self.assign[dst] = self.assign[src]

    # ------------------------------------------------------------------
    def save(self, path: str) -> None:
        """``lw/lw.npz`` (centroids, P, mu, the store widened to f32,
        assign) and ``lw/lw.json``, the reference's form."""
        os.makedirs(path, exist_ok=True)
        np.savez(os.path.join(path, "lw.npz"),
                 centroids=self.params.centroids.cpu().numpy(),
                 P=self.params.P.cpu().numpy(),
                 mu=self.params.mu.cpu().numpy(),
                 store=self.store.float().cpu().numpy(),
                 assign=self.assign.cpu().numpy())
        with open(os.path.join(path, "lw.json"), "w") as f:
            json.dump({"n_clusters": self.n_clusters, "dim": self.dim}, f)

    @classmethod
    def load(cls, path: str, device: "torch.device | str | None" = None
             ) -> "LocalWhiteningView":
        """A view saved by :meth:`save` or by the reference. ``device``
        defaults to the card (``utils.device.resolve_device``)."""
        device = resolve_device(device)
        raw = np.load(os.path.join(path, "lw.npz"))

        def put(key, dtype):
            return torch.from_numpy(np.ascontiguousarray(raw[key])).to(
                device=device, dtype=dtype)

        params = LocalWhiteningParams(centroids=put("centroids", torch.float32),
                                      P=put("P", torch.float32),
                                      mu=put("mu", torch.float32))
        return cls(params, put("store", torch.bfloat16),
                   put("assign", torch.int32))
