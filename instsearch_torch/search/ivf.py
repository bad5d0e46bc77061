"""IVF (inverted-file) ANN tier: a coarse k-means quantizer and a
cluster-pruned scan (port of ``instsearch_tpu/search/ivf.py``:
``_bucket_layout``, ``_fill_buckets``, ``_score_rows``,
``_ivf_candidates``, ``_ivf_composite``, ``IVFIndex`` and
``recall_vs_exact``).

Rows are bucketed by their nearest centroid (``ops/kmeans.py``), and a
query scores only the ``nprobe`` buckets whose centroids it matches best,
plus the spill. The layout is the reference's, static in shape:

  * buckets ``[C, M, D]`` in the store's dtype, M a fixed capacity a
    cluster (``cap_factor`` times the mean size, a multiple of 8); slots
    hold the rows' POSITIONS in the padded main store (``bucket_pos``, -1
    for an empty slot), so αQE and the regional re-rank gather from the
    main store exactly as on the exact path;
  * rows past a bucket's capacity land in the spill ``[S, D]``, scanned by
    every query, so ``nprobe == n_clusters`` stays exact search.

The buckets hold the descriptor width ``dim``, without the kernels' zero
columns of the port's store (they change no score), as the reference's
arrays and its saved ``ivf.npz`` have them. Scoring is the reference's
``_score_rows``: an f32 store scores in f32; a bf16 or int8 store scores the
bf16-rounded query against the stored values, the products exact in f32,
then times the row scale (int8). So a full-probe IVF over bf16 rows equals
K1's route, and over int8 rows the scoring oracle's route on the
bf16-rounded query. Every top-k is ``select_topk`` (a stable sort: ties to
the lowest slot, as ``lax.top_k``). There is no Pallas kernel on this
path in the reference (XLA ops), and none here.

``Index.add`` is absorbed (the new rows join the spill), ``Index.remove``
too (positions remapped, removed slots tombstoned to -1); ``augment_
database`` drops the view.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..ops.kmeans import assign_clusters, fit_kmeans, pick_chunk
from ..utils.chunking import run_chunked
from ..utils.device import resolve_device
from .bruteforce import select_topk
from .qe import expand_from_candidates
from .rerank import rerank_from_candidates

_NEG_INF = float("-inf")
# elements of one probe group's f32 rows [B, g, M, D]: 2^26 is 256 MiB
_SCAN_ELEMS = 1 << 26
# numpy names of the saved arrays' dtypes, as the reference writes them
_DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
                torch.int8: "int8", torch.int32: "int32"}
_DTYPES = {v: k for k, v in _DTYPE_NAMES.items()}


def _bucket_layout(assignments: np.ndarray, num_valid: int, n_clusters: int,
                   cap_factor: float):
    """Host-side layout pass: cluster assignment -> (bucket_pos [C, M],
    spill_pos [S]) of row POSITIONS, -1 padding. O(N) numpy, no Python
    per-row loop."""
    a = np.asarray(assignments[:num_valid])
    order = np.argsort(a, kind="stable").astype(np.int64)
    a_sorted = a[order]
    sizes = np.bincount(a, minlength=n_clusters)
    mean = max(1.0, num_valid / n_clusters)
    cap = int(min(sizes.max(initial=1),
                  max(8, int(np.ceil(cap_factor * mean)))))
    m = ((cap + 7) // 8) * 8
    starts = np.zeros(n_clusters + 1, np.int64)
    np.cumsum(sizes, out=starts[1:])
    rank = np.arange(num_valid, dtype=np.int64) - starts[a_sorted]
    keep = rank < m
    bucket_pos = np.full((n_clusters, m), -1, np.int32)
    bucket_pos[a_sorted[keep], rank[keep]] = order[keep]
    spill_pos = order[~keep].astype(np.int32)
    return bucket_pos, spill_pos


def _spill_slots(spill_pos: np.ndarray) -> np.ndarray:
    """The spill's positions padded with -1 to a multiple of 8 (at least 8;
    an empty spill stays empty), as the reference pads them."""
    n = len(spill_pos)
    s_pad = max(8, ((n + 7) // 8) * 8) if n else 0
    sp = np.full((s_pad,), -1, np.int32)
    sp[:n] = spill_pos
    return sp


def _fill_buckets(index, pos: torch.Tensor):
    """The bucketed view gathered from the main store (a placed store's
    through its placement, ``Index._stored_rows``): positions ``pos [...]``
    -> (rows ``[..., dim]`` in the store's dtype, zero at -1 slots; row
    scales ``[...]`` f32 or None)."""
    valid = pos >= 0
    rows, row_scales = index._stored_rows(pos.clamp(min=0))
    rows = rows[..., :index.dim]
    rows = torch.where(valid[..., None], rows,
                       torch.zeros((), dtype=rows.dtype, device=rows.device))
    scales = None
    if row_scales is not None:
        scales = torch.where(valid, row_scales,
                             torch.zeros((), device=pos.device))
    return rows, scales


def _score_rows(rows: torch.Tensor, row_scales, q: torch.Tensor
                ) -> torch.Tensor:
    """``rows [..., D]`` (store dtype) x ``q [B, D]`` -> f32 scores, times
    the row scales (int8). Shared ``[N, D]`` rows give ``[B, N]``; rows
    gathered per query ``[B, p, M, D]`` give ``[B, p, M]``. An f32 store
    scores in f32, a bf16 or int8 store the bf16-rounded query against its
    values (bf16 products are exact in f32), as the reference."""
    qc = q.float() if rows.dtype == torch.float32 else \
        q.to(torch.bfloat16).float()
    rf = rows.float()
    if rows.ndim == 2:
        s = qc @ rf.T
        return s if row_scales is None else s * row_scales[None, :]
    s = torch.einsum("bpmd,bd->bpm", rf, qc)
    return s if row_scales is None else s * row_scales


def _ivf_candidates(centroids, buckets, bucket_scales, bucket_pos, spill,
                    spill_scales, spill_pos, q, mask=None, *, k: int,
                    nprobe: int):
    """The pruned scan -> ``(scores [B, k] f32 descending, row positions
    [B, k] int32, -1 for empty slots)``: centroid product, top-``nprobe``,
    bucket gather, batched products (probes in groups that keep the f32
    rows under ``_SCAN_ELEMS``), merge with the always-scanned spill. ``q``
    may carry zero columns past the buckets' width. ``mask`` ([1, N] int8,
    ``search/subset.py``) is gathered by candidate position."""
    q = q[:, :centroids.shape[1]].float()
    b = q.shape[0]
    cids = select_topk(q @ centroids.T, nprobe)[1].long()      # [B, p]
    g = max(1, min(nprobe, _SCAN_ELEMS // max(1, b * buckets.shape[1]
                                              * buckets.shape[2])))
    s = torch.cat([
        _score_rows(buckets[c], None if bucket_scales is None
                    else bucket_scales[c], q).reshape(b, -1)
        for c in cids.split(g, dim=1)], dim=1)                 # [B, p*M]
    flat_p = bucket_pos[cids].reshape(b, -1)
    flat_s = s.masked_fill(flat_p < 0, _NEG_INF)
    if spill.shape[0]:
        sp = _score_rows(spill, spill_scales, q)               # [B, S]
        sp = sp.masked_fill(spill_pos[None, :] < 0, _NEG_INF)
        flat_s = torch.cat([flat_s, sp], dim=1)
        flat_p = torch.cat([flat_p, spill_pos[None, :].expand(b, -1)], dim=1)
    if mask is not None:
        allowed = mask[0][flat_p.clamp(min=0).long()] > 0
        flat_s = flat_s.masked_fill(~allowed, _NEG_INF)
    top_s, idx = select_topk(flat_s, k)
    top_p = torch.gather(flat_p, 1, idx.clamp(min=0).long())
    return top_s, torch.where(top_s > _NEG_INF, top_p,
                              torch.full_like(top_p, -1))


def _ivf_composite(ivf, rows_f32, ids, regional, query_regional, q,
                   vote_matrix=None, mask=None, *, k: int, depth: int,
                   qe_n: int, qe_alpha: float, nprobe: int, do_qe: bool,
                   do_rerank: bool, spatial_weight: float = 0.0):
    """The reference's ``_ivf_composite_jit``: the exact composite with
    every candidate selection the pruned scan; αQE rows and re-rank regions
    are read from the MAIN store by position: ``rows_f32(pos)`` gives the
    rows at positions ``pos [...]`` dequantized to f32 ``[..., W]``
    (``Index._rows_f32_at``), ``regional`` is the regional store or a
    reader of its rows (``search/rerank.py::region_similarities``); on a
    placed store both read only those rows from the shards. The scan reads
    the view's own bucket copies. ``ivf``: the view's seven arrays
    (``IVFIndex.arrays``). -> ``(scores [B, k], ids [B, k])``."""
    q = q.float()
    if do_qe:
        s, pos = _ivf_candidates(*ivf, q, mask, k=qe_n, nprobe=nprobe)
        rows = rows_f32(pos.clamp(min=0))
        rows = torch.where((s > _NEG_INF)[..., None], rows,
                           torch.zeros((), device=rows.device))
        q = expand_from_candidates(q, s, rows, qe_alpha)
    if do_rerank:
        g, pos = _ivf_candidates(*ivf, q, mask, k=depth, nprobe=nprobe)
        return rerank_from_candidates(
            regional, ids, g, pos, query_regional, k=k,
            spatial_weight=spatial_weight, vote_matrix=vote_matrix)
    s, pos = _ivf_candidates(*ivf, q, mask, k=k, nprobe=nprobe)
    out = torch.where(pos >= 0, ids[pos.clamp(min=0).long()],
                      torch.full_like(pos, -1))
    return s, out


def _remap_positions(p: torch.Tensor, pos_map: torch.Tensor) -> torch.Tensor:
    """Stored positions through ``pos_map`` (old -> new, -1 = removed); -1
    stays -1."""
    return torch.where(p >= 0, pos_map[p.clamp(min=0).long()],
                       torch.full_like(p, -1))


class IVFIndex:
    """Cluster-pruned ANN view over an :class:`instsearch_torch.index.Index`,
    on the index's device. Built by :meth:`from_index` (or
    ``Index.build_ivf``); ``Index.search`` routes through it when
    ``SearchConfig.ivf_nprobe > 0``. The main store stays authoritative:
    buckets hold row positions."""

    def __init__(self, centroids, buckets, bucket_scales, bucket_pos, spill,
                 spill_scales, spill_pos, nprobe: int = 32):
        self.centroids = centroids            # [C, D] f32, unit rows
        self.buckets = buckets                # [C, M, D] store dtype
        self.bucket_scales = bucket_scales    # [C, M] f32 | None
        self.bucket_pos = bucket_pos          # [C, M] int32 positions
        self.spill = spill                    # [S_pad, D] store dtype
        self.spill_scales = spill_scales      # [S_pad] f32 | None
        self.spill_pos = spill_pos            # [S_pad] int32
        self.nprobe = nprobe

    @property
    def arrays(self) -> tuple:
        """The seven arrays of the candidate scan, in its argument order."""
        return (self.centroids, self.buckets, self.bucket_scales,
                self.bucket_pos, self.spill, self.spill_scales,
                self.spill_pos)

    @property
    def n_clusters(self) -> int:
        return self.centroids.shape[0]

    @property
    def bucket_capacity(self) -> int:
        return self.buckets.shape[1]

    @property
    def device(self) -> torch.device:
        return self.centroids.device

    def scan_fraction(self, nprobe: int | None = None) -> float:
        """Fraction of index rows a query touches (bucket slots + spill)."""
        p = min(nprobe or self.nprobe, self.n_clusters)
        total = self.n_clusters * self.bucket_capacity + self.spill.shape[0]
        return (p * self.bucket_capacity + self.spill.shape[0]) / max(total, 1)

    # ------------------------------------------------------------------
    @classmethod
    def from_index(cls, index, n_clusters: int | None = None,
                   nprobe: int = 32, iters: int = 10, seed: int = 0,
                   cap_factor: float = 4.0,
                   sample: int | None = 262_144) -> "IVFIndex":
        """Fit the coarse quantizer and bucket the index rows, on the
        index's device. ``n_clusters`` defaults to ~sqrt(N) rounded to a
        power of two; the k-means fit runs on at most ``sample`` rows drawn
        by ``default_rng(seed)`` (assignment covers every row), as the
        reference. ``cap_factor`` caps a bucket at that multiple of the
        mean cluster size; the rest spills."""
        nv = index.num_valid
        if nv < 2:
            raise ValueError("IVF needs at least 2 indexed rows")
        if n_clusters is None:
            n_clusters = max(2, 1 << int(round(np.log2(max(2, np.sqrt(nv))))))
        n_clusters = min(n_clusters, nv)
        n_pad = index.n_pad
        chunk = pick_chunk(n_pad)
        if sample is not None and nv > sample:
            rng = np.random.default_rng(seed)
            take = np.sort(rng.choice(nv, size=sample, replace=False))
            fit_rows = index._rows_f32_at(
                torch.as_tensor(take, device=index.device))[:, :index.dim]
            cent, _ = fit_kmeans(fit_rows, n_clusters, iters=iters, seed=seed)
            assignments = torch.cat([
                assign_clusters(index._rows_f32_chunk(s, chunk), cent,
                                max(0, min(chunk, nv - s)))
                for s in range(0, n_pad, chunk)])
        else:
            cent, assignments = fit_kmeans(
                index._rows_f32_chunk(0, n_pad), n_clusters, num_valid=nv,
                iters=iters, seed=seed)
        bucket_pos, spill_pos = _bucket_layout(
            assignments.cpu().numpy(), nv, n_clusters, cap_factor)
        bucket_pos = torch.as_tensor(bucket_pos, device=index.device)
        spill_pos = torch.as_tensor(_spill_slots(spill_pos),
                                    device=index.device)
        buckets, bscales = _fill_buckets(index, bucket_pos)
        spill, sscales = _fill_buckets(index, spill_pos)
        return cls(cent, buckets, bscales, bucket_pos, spill, sscales,
                   spill_pos, nprobe=nprobe)

    # ------------------------------------------------------------------
    def absorb_add(self, index, start: int, n_new: int) -> None:
        """Absorb the rows ``[start, start + n_new)`` just written to the
        main store into the always-scanned spill, in the store's dtype: the
        buckets are untouched, so full probe stays exact search and any
        nprobe sees the new rows. The rows go in as a power-of-two block
        (-1 positions past ``n_new``, masked like padding) after the valid
        prefix; the spill grows to twice its size when it would overflow,
        as the reference's."""
        blk = max(8, 1 << max(0, n_new - 1).bit_length())
        pos_blk = torch.full((blk,), -1, dtype=torch.int32,
                             device=self.device)
        pos_blk[:n_new] = torch.arange(start, start + n_new,
                                       dtype=torch.int32, device=self.device)
        rows_blk, sc_blk = _fill_buckets(index, pos_blk)
        used = int((self.spill_pos >= 0).sum())
        cap = int(self.spill_pos.shape[0])
        if used + blk > cap:
            self.reserve_spill(max(used + blk, 2 * cap), index)
        self.spill[used:used + blk] = rows_blk
        self.spill_pos[used:used + blk] = pos_blk
        if self.spill_scales is not None:
            self.spill_scales[used:used + blk] = sc_blk

    def reserve_spill(self, min_capacity: int, index) -> None:
        """Grow the spill arrays to at least ``min_capacity`` slots, rounded
        up to a power of two, without adding entries; the new rows take
        ``index``'s row width (``dim``) and store dtype, as the reference
        takes its store's. The reference does it to keep its compiled
        programs' shapes; eager PyTorch compiles nothing, but the grown
        arrays are the view's state (a saved view carries them) and
        ``ServeCore`` reserves them as the reference's does."""
        cap = int(self.spill_pos.shape[0])
        want = max(8, 1 << max(0, min_capacity - 1).bit_length())
        if want <= cap:
            return
        grow = want - cap
        self.spill = torch.cat([self.spill, self.spill.new_zeros(
            (grow, index.dim), dtype=index.store_dtype)])
        self.spill_pos = torch.cat([self.spill_pos,
                                    self.spill_pos.new_full((grow,), -1)])
        if self.spill_scales is not None:
            self.spill_scales = torch.cat([self.spill_scales,
                                           self.spill_scales.new_zeros(grow)])

    def absorb_remove(self, pos_map: torch.Tensor) -> None:
        """Absorb ``Index.remove``'s compaction: every stored position
        through ``pos_map`` (old -> new; removed rows -> -1, masked like
        padding). Row values are untouched (moves never change them); the
        spill keeps its valid entries first, in order, for
        :meth:`absorb_add`'s cursor."""
        self.bucket_pos = _remap_positions(self.bucket_pos, pos_map)
        if self.spill_pos.shape[0]:
            sp = _remap_positions(self.spill_pos, pos_map)
            order = torch.sort((sp < 0).to(torch.int32), stable=True)[1]
            self.spill_pos = sp[order]
            self.spill = self.spill[order]
            if self.spill_scales is not None:
                self.spill_scales = self.spill_scales[order]

    # ------------------------------------------------------------------
    def candidates(self, queries, k: int, nprobe: int | None = None,
                   mask=None):
        """``(scores [B, k], row POSITIONS [B, k])``, the composable form;
        ``mask``: an optional ``[1, N]`` int8 subset filter. Batches run in
        pieces that keep the ``[B, nprobe, M, D]`` gather under 256 MiB."""
        p = min(nprobe or self.nprobe, self.n_clusters)
        q = torch.as_tensor(queries, device=self.device).float()
        if q.ndim == 1:
            q = q[None]
        row_bytes = self.buckets.shape[2] * self.buckets.element_size()
        per_q = max(1, p * self.bucket_capacity * row_bytes)
        chunk = max(1, min(q.shape[0], (256 << 20) // per_q))
        return run_chunked(
            lambda qq: _ivf_candidates(*self.arrays, qq, mask, k=k,
                                       nprobe=p), chunk, q)

    def search(self, index, queries, k: int = 10, nprobe: int | None = None,
               mask=None):
        """Descriptor-space ANN search -> ``(scores [B, k], dataset ids
        [B, k])`` numpy arrays, as ``Index.search`` returns; ``index`` maps
        positions to dataset ids."""
        s, pos = self.candidates(queries, k, nprobe, mask=mask)
        ids = torch.where(pos >= 0, index.ids[pos.clamp(min=0).long()],
                          torch.full_like(pos, -1))
        return s.cpu().numpy(), ids.cpu().numpy()

    def measure_recall(self, index, queries, k: int = 10,
                       nprobe: int | None = None) -> float:
        """recall@k against the exact ranking of the index with the view's
        routing off (``ivf_nprobe=0``: with the view attached the "exact"
        side would otherwise be the ANN answer itself)."""
        _, exact_ids = index.search(
            queries, index.cfg.search.replace(k=k, qe_enabled=False,
                                              rerank_enabled=False,
                                              ivf_nprobe=0))
        _, ivf_ids = self.search(index, queries, k=k, nprobe=nprobe)
        return recall_vs_exact(exact_ids, ivf_ids)

    # ------------------------------------------------------------------
    def _state(self) -> dict:
        state = {"centroids": self.centroids, "buckets": self.buckets,
                 "bucket_pos": self.bucket_pos, "spill": self.spill,
                 "spill_pos": self.spill_pos}
        if self.bucket_scales is not None:
            state["bucket_scales"] = self.bucket_scales
            state["spill_scales"] = self.spill_scales
        return state

    def save(self, path: str) -> None:
        """The reference's form: ``ivf.npz`` (bf16 arrays widened to f32)
        and ``ivf.json`` (nprobe and each array's dtype)."""
        os.makedirs(path, exist_ok=True)
        state = self._state()
        np.savez(os.path.join(path, "ivf.npz"),
                 **{k: (v.float() if v.dtype == torch.bfloat16 else v
                        ).cpu().numpy() for k, v in state.items()})
        with open(os.path.join(path, "ivf.json"), "w") as f:
            json.dump({"nprobe": self.nprobe,
                       "dtypes": {k: _DTYPE_NAMES[v.dtype]
                                  for k, v in state.items()}}, f)

    @classmethod
    def load(cls, path: str, *, device: "torch.device | str | None" = None
             ) -> "IVFIndex":
        """A view saved by :meth:`save` or by the reference, onto
        ``device`` (default: the card, raising without one)."""
        dev = resolve_device(device)
        with open(os.path.join(path, "ivf.json")) as f:
            meta = json.load(f)
        raw = np.load(os.path.join(path, "ivf.npz"))
        d = {k: torch.from_numpy(np.ascontiguousarray(raw[k])).to(dev).to(
            _DTYPES[meta["dtypes"][k]]) for k in raw.files}
        return cls(d["centroids"], d["buckets"], d.get("bucket_scales"),
                   d["bucket_pos"], d["spill"], d.get("spill_scales"),
                   d["spill_pos"], nprobe=int(meta["nprobe"]))


def recall_vs_exact(exact_ids, approx_ids) -> float:
    """Set-overlap recall of ``approx_ids`` against the exact top-k,
    averaged over queries (``[Q, k]`` id arrays, -1 = empty slot)."""
    hits = 0
    total = 0
    for e, a in zip(np.asarray(exact_ids), np.asarray(approx_ids)):
        e = set(int(i) for i in e if i >= 0)
        if not e:
            continue
        hits += len(e & set(int(i) for i in a if i >= 0))
        total += len(e)
    return hits / max(total, 1)
