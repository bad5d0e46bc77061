"""IVF-PQ: coarse k-means pruning over 4-bit residual PQ codes, and the
host row store of capacity serving (port of
``instsearch_tpu/search/ivfpq.py``: ``_adc_block``, ``_adc_select``,
``_ivfpq_candidates``, ``_ivfpq_composite``, ``IVFPQView`` and
``HostRowStore``).

Codes quantize the RESIDUAL ``r = x - c(x)`` of each row against its coarse
centroid, and for the inner product

    score(q, x^) = q . c + q . r^ = cq[cluster] + sum_m lut[m, code_m],

so one query lookup table serves every bucket: the per-bucket term is the
centroid score the probe selection already computed. The layout is the IVF
tier's (``search/ivf.py::_bucket_layout``): codes ``[C, M, m/2]``, packed
nibbles as ``ops/pq.py`` packs them (no word padding: K4 does not read
them), positions ``[C, M]``, and the always-scanned spill's codes,
positions and cluster ids. Every candidate stage is a cascade: the ADC
selects ``depth`` candidates, which are re-scored exactly against the main
store, so full probe with ``depth`` >= the valid rows is exact search.

The reference computes the ADC as a one-hot x table einsum,
``[B, g*M, m, 16]`` f32 for a group of up to 8 probes (several GB at 1M
rows, B = 128). Here the same sum is the table GATHERED by the codes,
``[B, g*M, m]``, summed over m: the same function in another order of f32
additions. Probes go in groups that keep the gather under ``_ADC_ELEMS``
elements. There is no Pallas kernel on this path in the reference (XLA
ops), and none here. Every top-k is ``select_topk`` (a stable sort, ties to
the lowest slot, as ``lax.top_k``).

Capacity serving keeps only the codes on the card: ``HostRowStore`` is the
exact rows in a memory-mapped host file (the reference's on-disk form:
``rows.bin``, ``scales.bin``, ``ids.bin``, ``store.json``),
``IVFPQView.from_host_store`` fits the view from it, and
``search_host`` runs the ADC selection on the card, then gathers and
re-scores its ``depth`` rows a query on the host in numpy.
"""
from __future__ import annotations

import json
import math
import os

import numpy as np
import torch

from ..ops.kmeans import assign_clusters, fit_kmeans, pick_chunk
from ..ops.pq import (PQCodebook, default_m, encode_apq, encode_pq, fit_apq,
                      fit_opq, fit_pq, pq_lut)
from ..utils.device import resolve_device
from .bruteforce import select_topk
from .ivf import (_bucket_layout, _remap_positions, _spill_slots,
                  recall_vs_exact)
from .qe import expand_from_candidates
from .rerank import rerank_from_candidates

_NEG_INF = float("-inf")
# elements of one probe group's gathered table [B, g*M, m] (and of its int64
# lookup indices): 2^24 keeps the pair under 200 MiB
_ADC_ELEMS = 1 << 24


def _lut_index(codes: torch.Tensor) -> torch.Tensor:
    """Packed codes ``[..., m/2]`` int8 -> ``[..., m]`` int64 positions in a
    flattened ``[m * 16]`` table: subspace j's code is the low nibble of
    byte j, subspace j + m/2's the high one (``ops/pq.py::unpack_pq``)."""
    c = torch.cat([codes & 15, (codes >> 4) + 8], dim=-1).long()
    m = c.shape[-1]
    return c.add_(16 * torch.arange(m, device=codes.device))


def _adc_sum(lut: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """ADC scores of codes gathered per query: ``lut [B, m * 16]`` f32,
    ``codes [B, n, m/2]`` -> ``[B, n]``, the table's entries at the codes
    summed over the m subspaces."""
    b, n, _ = codes.shape
    vals = torch.gather(lut, 1, _lut_index(codes).reshape(b, -1))
    return vals.reshape(b, n, -1).sum(dim=-1)


def _adc_block(codes: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """ADC scores of a code block shared by every query: ``codes [N', m/2]``
    x ``lut [B, m * 16]`` -> ``[B, N']``, in pieces of rows within
    ``_ADC_ELEMS``."""
    b, half = lut.shape[0], codes.shape[1]
    step = max(1, _ADC_ELEMS // max(1, b * 2 * half))
    return torch.cat([_adc_sum(lut, codes[s:s + step][None].expand(b, -1, -1))
                      for s in range(0, codes.shape[0], step)], dim=1)


def _adc_select(centroids, codes, bucket_pos, spill_codes, spill_pos,
                spill_cluster, pq_centroids, rotation, q, mask=None, *,
                depth: int, nprobe: int):
    """The pruned residual-ADC selection, without the exact re-score:
    centroid product, top-``nprobe``, the probed buckets' codes, ADC plus
    the centroid score, merge with the spill, top-``depth`` -> ``(ADC scores
    [B, dd], positions [B, dd])``, dd = min(depth, scanned slots). The
    first eight arguments are ``IVFPQView.arrays``. ``q`` may carry zero
    columns past the centroids' width. With an OPQ ``rotation`` (or None)
    the table scores the rotated query; the centroid term keeps the query.
    ``mask`` ([1, N] int8) applies here, so the depth goes to allowed
    rows."""
    qf = q[:, :centroids.shape[1]].float()
    b = qf.shape[0]
    cq = qf @ centroids.T                                       # [B, C]
    cids = select_topk(cq, nprobe)[1].long()                    # [B, p]
    q_adc = qf if rotation is None else qf @ rotation
    lut = pq_lut(q_adc, PQCodebook(pq_centroids)).reshape(b, -1)
    m_cap, half = codes.shape[1], codes.shape[2]
    coff = torch.gather(cq, 1, cids)                            # [B, p]
    g = max(1, min(nprobe, _ADC_ELEMS // max(1, b * m_cap * 2 * half)))
    parts = []
    for j in range(0, nprobe, g):
        cg = codes[cids[:, j:j + g]]                       # [B, g, M, m/2]
        s = _adc_sum(lut, cg.reshape(b, -1, half)).reshape(b, -1, m_cap)
        parts.append((s + coff[:, j:j + g, None]).reshape(b, -1))
    flat_p = bucket_pos[cids].reshape(b, -1)
    flat_s = torch.cat(parts, dim=1).masked_fill(flat_p < 0, _NEG_INF)
    if spill_codes.shape[0]:
        sp = (_adc_block(spill_codes, lut)
              + cq[:, spill_cluster.clamp(min=0).long()])
        sp = sp.masked_fill(spill_pos[None, :] < 0, _NEG_INF)
        flat_s = torch.cat([flat_s, sp], dim=1)
        flat_p = torch.cat([flat_p, spill_pos[None, :].expand(b, -1)], dim=1)
    if mask is not None:
        allowed = mask[0][flat_p.clamp(min=0).long()] > 0
        flat_s = flat_s.masked_fill(~allowed, _NEG_INF)
    adc_s, idx = select_topk(flat_s, min(depth, flat_s.shape[1]))
    pos = torch.gather(flat_p, 1, idx.clamp(min=0).long())
    return adc_s, torch.where(adc_s > _NEG_INF, pos, torch.full_like(pos, -1))


def _ivfpq_candidates(view_arrays, rows_f32, q, mask=None, *, depth: int,
                      nprobe: int):
    """The cascade stage: the pruned ADC selection, then the exact f32
    re-score of its candidates from the main store (the ORIGINAL query
    against unrotated rows) and a re-sort -> ``(exact scores [B, depth]
    descending, positions [B, depth], -1 empty)``. ``view_arrays``:
    ``IVFPQView.arrays``; ``rows_f32(pos)`` reads the store's rows at
    positions ``pos [...]`` dequantized to f32 ``[..., W]``
    (``Index._rows_f32_at``: a placed store's from its shards, only those
    rows); ``q`` has the store's width."""
    qf = q.float()
    adc_s, pos = _adc_select(*view_arrays, qf, mask=mask, depth=depth,
                             nprobe=nprobe)
    dd = adc_s.shape[1]
    rows = rows_f32(pos.clamp(min=0))
    exact = torch.einsum("bkd,bd->bk", rows, qf).masked_fill(pos < 0,
                                                             _NEG_INF)
    exact, order = torch.sort(exact, dim=1, descending=True, stable=True)
    pos = torch.gather(pos, 1, order)
    pos = torch.where(exact > _NEG_INF, pos, torch.full_like(pos, -1))
    if dd < depth:
        exact = torch.nn.functional.pad(exact, (0, depth - dd),
                                        value=_NEG_INF)
        pos = torch.nn.functional.pad(pos, (0, depth - dd), value=-1)
    return exact, pos


def _ivfpq_composite(view_arrays, rows_f32, ids, regional, query_regional,
                     q, vote_matrix=None, mask=None, *, k: int, depth: int,
                     qe_n: int, qe_alpha: float, nprobe: int, do_qe: bool,
                     do_rerank: bool, spatial_weight: float = 0.0,
                     rerank_depth: int = 0):
    """The reference's ``_ivfpq_composite_jit``: every candidate stage is
    the cascade; αQE rows (``rows_f32``) and re-rank regions (``regional``,
    the regional store or a reader of its rows) are read from the MAIN
    store by position. -> ``(scores [B, k], ids [B, k])``."""
    q = q.float()

    def sel(qq):
        return _ivfpq_candidates(view_arrays, rows_f32, qq, mask,
                                 depth=depth, nprobe=nprobe)
    if do_qe:
        s, pos = sel(q)
        s_n, pos_n = s[:, :qe_n], pos[:, :qe_n]
        rows = rows_f32(pos_n.clamp(min=0))
        rows = torch.where((s_n > _NEG_INF)[..., None], rows,
                           torch.zeros((), device=rows.device))
        q = expand_from_candidates(q, s_n, rows, qe_alpha)
    s, pos = sel(q)
    if do_rerank:
        rd = min(rerank_depth or depth, depth)
        return rerank_from_candidates(
            regional, ids, s[:, :rd], pos[:, :rd], query_regional, k=k,
            spatial_weight=spatial_weight, vote_matrix=vote_matrix)
    out = torch.where(pos >= 0, ids[pos.clamp(min=0).long()],
                      torch.full_like(pos, -1))
    return s[:, :k], out[:, :k]


def _put(a, dtype, dev) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(dev)


class IVFPQView:
    """Pruned compressed-domain cascade view over an
    :class:`instsearch_torch.index.Index` (or a :class:`HostRowStore`), on
    one device. Built by :meth:`from_index` (or ``Index.build_ivfpq``);
    ``Index.search`` routes through it when ``SearchConfig.ivfpq_nprobe >
    0``. The main store stays authoritative (codes hold row positions and
    every candidate is re-scored exactly), so quality depends on candidate
    recall over (nprobe, depth): :meth:`measure_recall`."""

    def __init__(self, centroids, codes, bucket_pos, spill_codes, spill_pos,
                 spill_cluster, codebook: PQCodebook, nprobe: int = 32,
                 depth: int = 400, rotation=None,
                 anisotropic_t: "float | None" = None):
        self.centroids = centroids          # [C, D] f32 unit rows
        self.codes = codes                  # [C, M, m/2] int8 packed
        self.bucket_pos = bucket_pos        # [C, M] int32 positions
        self.spill_codes = spill_codes      # [S_pad, m/2] int8
        self.spill_pos = spill_pos          # [S_pad] int32
        self.spill_cluster = spill_cluster  # [S_pad] int32 (-1 pad)
        self.codebook = codebook            # residual-space [m, 16, ds]
        self.rotation = rotation            # OPQ residual-space [D, D]
        self.anisotropic_t = anisotropic_t  # the anisotropic fit's threshold
        self.nprobe = nprobe
        self.depth = depth

    @property
    def arrays(self) -> tuple:
        """The arrays of ``_adc_select``, in its argument order."""
        return (self.centroids, self.codes, self.bucket_pos,
                self.spill_codes, self.spill_pos, self.spill_cluster,
                self.codebook.centroids, self.rotation)

    @property
    def n_clusters(self) -> int:
        return self.centroids.shape[0]

    @property
    def bucket_capacity(self) -> int:
        return self.codes.shape[1]

    @property
    def m(self) -> int:
        return self.codebook.m

    @property
    def bytes_per_row(self) -> int:
        return self.codes.shape[2]

    @property
    def device(self) -> torch.device:
        return self.centroids.device

    def scan_fraction(self, nprobe: int | None = None) -> float:
        p = min(nprobe or self.nprobe, self.n_clusters)
        total = (self.n_clusters * self.bucket_capacity
                 + self.spill_codes.shape[0])
        return (p * self.bucket_capacity
                + self.spill_codes.shape[0]) / max(total, 1)

    # ------------------------------------------------------------------
    @classmethod
    def from_index(cls, index, n_clusters: int | None = None,
                   nprobe: int = 32, m: int | None = None,
                   kmeans_iters: int = 10, pq_iters: int = 15,
                   seed: int = 0, cap_factor: float = 4.0,
                   sample: "int | None" = 262_144, depth: int = 400,
                   chunk: int = 65_536, opq_iters: int = 0,
                   anisotropic_t: "float | None" = None) -> "IVFPQView":
        """Coarse k-means fit, residual PQ fit, chunked encode and bucket
        layout over the index's dequantized rows (without the store's zero
        columns), on the index's device. ``opq_iters > 0`` learns an OPQ
        rotation in residual space; ``anisotropic_t`` fits and encodes the
        residual codes under the score-aware loss with the original rows as
        the directions (``ops/pq.py::fit_apq``)."""
        return cls._fit(index._rows_f32_chunk, index.num_valid,
                        index.n_pad, index.dim,
                        device=index.device, n_clusters=n_clusters,
                        nprobe=nprobe, m=m, kmeans_iters=kmeans_iters,
                        pq_iters=pq_iters, seed=seed, cap_factor=cap_factor,
                        sample=sample, depth=depth, chunk=chunk,
                        opq_iters=opq_iters, anisotropic_t=anisotropic_t)

    @classmethod
    def _fit(cls, rows_f32, nv: int, n_pad: int, d: int, *, device,
             n_clusters, nprobe, m, kmeans_iters, pq_iters, seed, cap_factor,
             sample, depth, chunk, opq_iters, anisotropic_t=None,
             rows_dev=None, rows_sample=None) -> "IVFPQView":
        """The fit core of :meth:`from_index` and :meth:`from_host_store`:
        ``rows_f32(start, count)`` yields dequantized f32 row chunks
        wherever the rows live (a device store or a host memmap);
        ``rows_dev`` the same chunks on ``device`` for the encode pass
        (default: ``rows_f32``'s, moved); ``rows_sample(idx)`` the rows at
        sorted positions ``idx`` at once (a memmap reads just those)."""
        if nv < 16:
            raise ValueError("IVF-PQ needs at least 16 indexed rows")
        if anisotropic_t is not None and opq_iters > 0:
            raise ValueError(
                "anisotropic_t and opq_iters are mutually exclusive "
                "(the score-aware alternation is not defined through a "
                "jointly-learned rotation; pick one)")
        if n_clusters is None:
            n_clusters = max(2, 1 << int(round(np.log2(max(2, np.sqrt(nv))))))
        n_clusters = min(n_clusters, nv)
        if m is None:
            m = default_m(d)
        chunk = math.gcd(n_pad, max(8, chunk))

        def on_device(a):
            if isinstance(a, np.ndarray) and not a.flags.writeable:
                a = a.copy()                    # a read-only memmap view
            return torch.as_tensor(a, device=device).float()

        # coarse quantizer on the (sampled) dequantized rows
        if sample is not None and nv > sample:
            rng = np.random.default_rng(seed)
            take = np.sort(rng.choice(nv, size=sample, replace=False))
            if rows_sample is not None:
                fit_x = on_device(rows_sample(take))
            else:
                parts = []
                for start in range(0, n_pad, chunk):
                    sel = take[(take >= start) & (take < start + chunk)]
                    if len(sel):
                        sl = on_device(rows_f32(start, chunk))
                        parts.append(sl[torch.as_tensor(sel - start,
                                                        device=device)])
                fit_x = torch.cat(parts)
        else:
            fit_x = torch.cat([on_device(rows_f32(s, chunk))
                               for s in range(0, n_pad, chunk)])[:nv]
        cent, _ = fit_kmeans(fit_x, n_clusters, iters=kmeans_iters, seed=seed)

        # residual PQ fit on the sample
        nfit = fit_x.shape[0]
        pad = (-nfit) % 8
        fit_pad = torch.nn.functional.pad(fit_x, (0, 0, 0, pad))
        a_fit = assign_clusters(fit_pad, cent, nfit,
                                chunk=pick_chunk(nfit + pad))[:nfit]
        res_fit = fit_x - cent[a_fit.clamp(min=0).long()]
        rot = None
        if anisotropic_t is not None:
            cb = fit_apq(res_fit, m=m, directions=fit_x, t=anisotropic_t,
                         init_iters=pq_iters, seed=seed)
        elif opq_iters > 0:
            rot, cb = fit_opq(res_fit, m=m, opq_iters=opq_iters,
                              pq_iters=pq_iters, seed=seed)
        else:
            cb = fit_pq(res_fit, m=m, iters=pq_iters, seed=seed)

        # every row: assignment and residual encode, a chunk at a time
        if rows_dev is None:
            def rows_dev(start, count):
                return on_device(rows_f32(start, count))
        assignments = torch.empty((n_pad,), dtype=torch.int32, device=device)
        codes_all = torch.empty((n_pad, m // 2), dtype=torch.int8,
                                device=device)
        for start in range(0, n_pad, chunk):
            sl = rows_dev(start, chunk)
            nv_local = int(np.clip(nv - start, 0, chunk))
            a = assign_clusters(sl, cent, nv_local, chunk=pick_chunk(chunk))
            res = sl - cent[a.clamp(min=0).long()]
            assignments[start:start + chunk] = a
            if rot is not None:
                res = res @ rot
            codes_all[start:start + chunk] = (
                encode_apq(res, cb, directions=sl, t=anisotropic_t)
                if anisotropic_t is not None else encode_pq(res, cb))

        a_np = assignments.cpu().numpy()
        bucket_pos, spill_pos = _bucket_layout(a_np, nv, n_clusters,
                                               cap_factor)
        sp = _spill_slots(spill_pos)
        spc = np.full(sp.shape, -1, np.int32)
        spc[:len(spill_pos)] = a_np[spill_pos]
        bucket_pos = torch.as_tensor(bucket_pos, device=device)
        sp_t = torch.as_tensor(sp, device=device)

        def codes_at(pos):
            c = codes_all[pos.clamp(min=0).long()]
            return torch.where((pos >= 0)[..., None], c,
                               torch.zeros((), dtype=c.dtype, device=device))
        return cls(cent, codes_at(bucket_pos), bucket_pos, codes_at(sp_t),
                   sp_t, torch.as_tensor(spc, device=device), cb,
                   nprobe=nprobe, depth=depth, rotation=rot,
                   anisotropic_t=anisotropic_t)

    # ------------------------------------------------------------------
    def _encode(self, rows: torch.Tensor):
        """Rows ``[n, D]`` f32 -> (coarse assignments [n], residual codes
        [n, m/2]) under the frozen quantizer, codebook and rotation (or the
        anisotropic loss the view was fitted with)."""
        n = rows.shape[0]
        a = assign_clusters(rows, self.centroids, n, chunk=pick_chunk(n))
        res = rows - self.centroids[a.clamp(min=0).long()]
        if self.rotation is not None:
            res = res @ self.rotation
        if self.anisotropic_t is not None:
            return a, encode_apq(res, self.codebook, directions=rows,
                                 t=self.anisotropic_t)
        return a, encode_pq(res, self.codebook)

    def absorb_add(self, index, start: int, n_new: int) -> None:
        """Absorb the rows ``[start, start + n_new)`` just written to the
        main store: their residual codes under the frozen quantizer and
        codebook, with positions and clusters, join the always-scanned
        spill, so any nprobe sees them and the exact re-score keeps scores
        exact. The reference's window is encoded: the next power of two at
        least ``n_new`` (at least 8) rows from ``start``, moved back when
        it would run past the store; the new rows' entries go in as a
        power-of-two block, and the spill doubles when it would overflow."""
        n_pad = index.n_pad
        p = max(8, 1 << max(0, n_new - 1).bit_length())
        s0 = 0 if p >= n_pad else min(start, n_pad - p)
        a, codes = self._encode(index._rows_f32_chunk(s0, min(p, n_pad)))
        off = start - s0
        blk = max(8, 1 << max(0, n_new - 1).bit_length())
        dev = self.device
        codes_blk = torch.zeros((blk, self.codes.shape[2]), dtype=torch.int8,
                                device=dev)
        codes_blk[:n_new] = codes[off:off + n_new]
        pos_blk = torch.full((blk,), -1, dtype=torch.int32, device=dev)
        pos_blk[:n_new] = torch.arange(start, start + n_new,
                                       dtype=torch.int32, device=dev)
        clu_blk = torch.full((blk,), -1, dtype=torch.int32, device=dev)
        clu_blk[:n_new] = a[off:off + n_new]
        used = int((self.spill_pos >= 0).sum())
        cap = int(self.spill_pos.shape[0])
        if used + blk > cap:
            self.reserve_spill(max(used + blk, 2 * cap))
        self.spill_codes[used:used + blk] = codes_blk
        self.spill_pos[used:used + blk] = pos_blk
        self.spill_cluster[used:used + blk] = clu_blk

    def reserve_spill(self, min_capacity: int) -> None:
        """Grow the spill arrays to at least ``min_capacity`` slots, rounded
        up to a power of two, without adding entries (the reference keeps
        its compiled shapes so; here the grown arrays are the view's state,
        which a saved view carries, and ``ServeCore`` reserves them as the
        reference's does)."""
        cap = int(self.spill_pos.shape[0])
        want = max(8, 1 << max(0, min_capacity - 1).bit_length())
        if want <= cap:
            return
        grow = want - cap
        self.spill_codes = torch.cat([self.spill_codes,
                                      self.spill_codes.new_zeros(
                                          (grow, self.codes.shape[2]))])
        self.spill_pos = torch.cat([self.spill_pos,
                                    self.spill_pos.new_full((grow,), -1)])
        self.spill_cluster = torch.cat([self.spill_cluster,
                                        self.spill_cluster.new_full((grow,),
                                                                    -1)])

    def absorb_remove(self, pos_map: torch.Tensor) -> None:
        """Absorb ``Index.remove``'s compaction: stored positions through
        ``pos_map`` (removed -> -1, masked like padding). Codes quantize row
        values, which moves do not change; the spill keeps its valid
        entries first, in order, for :meth:`absorb_add`'s cursor."""
        self.bucket_pos = _remap_positions(self.bucket_pos, pos_map)
        if self.spill_pos.shape[0]:
            sp = _remap_positions(self.spill_pos, pos_map)
            order = torch.sort((sp < 0).to(torch.int32), stable=True)[1]
            self.spill_pos = sp[order]
            self.spill_codes = self.spill_codes[order]
            self.spill_cluster = torch.where(
                self.spill_pos >= 0, self.spill_cluster[order],
                torch.full_like(self.spill_pos, -1))

    # ------------------------------------------------------------------
    def candidates(self, index, queries, depth: int | None = None,
                   nprobe: int | None = None):
        """``(exact scores [B, depth], row POSITIONS [B, depth])``, the
        cascade stage already re-scored. A placed index
        (``Index.load(mesh=)``) stays placed: the re-score reads its
        candidates' rows from the shards (across processes, collectively:
        every process calls this with the same queries)."""
        p = min(nprobe or self.nprobe, self.n_clusters)
        q = torch.as_tensor(queries, device=index.device).float()
        if q.ndim == 1:
            q = q[None]
        return _ivfpq_candidates(self.arrays, index._rows_f32_at,
                                 index._match_query_dim(q),
                                 depth=depth or self.depth, nprobe=p)

    def search(self, index, queries, k: int = 10, depth: int | None = None,
               nprobe: int | None = None):
        """``(scores [B, k], dataset ids [B, k])`` numpy arrays."""
        s, pos = self.candidates(index, queries, depth, nprobe)
        ids = torch.where(pos >= 0, index.ids[pos.clamp(min=0).long()],
                          torch.full_like(pos, -1))
        return s[:, :k].cpu().numpy(), ids[:, :k].cpu().numpy()

    # ------------------------------------------------------------------
    @classmethod
    def from_host_store(cls, store: "HostRowStore",
                        n_clusters: int | None = None, nprobe: int = 32,
                        m: int | None = None, kmeans_iters: int = 10,
                        pq_iters: int = 15, seed: int = 0,
                        cap_factor: float = 4.0,
                        sample: "int | None" = 262_144, depth: int = 400,
                        chunk: int = 65_536, opq_iters: int = 0,
                        anisotropic_t: "float | None" = None,
                        *, device: "torch.device | str | None" = None
                        ) -> "IVFPQView":
        """The view fitted straight from a :class:`HostRowStore`, on
        ``device`` (default: the card, raising without one): no index on
        the device, only the codes. The encode pass ships each chunk's raw
        storage bytes and dequantizes on the device (``rows_device``); the
        coarse fit reads only its sampled rows."""
        dev = resolve_device(device)

        def rows_sample(idx):
            blk = np.asarray(store.rows[idx], np.float32)
            if store.scales is not None:
                blk = blk * store.scales[idx][:, None]
            return blk

        return cls._fit(store.rows_f32, store.n, store.n, store.d,
                        device=dev, n_clusters=n_clusters, nprobe=nprobe,
                        m=m, kmeans_iters=kmeans_iters, pq_iters=pq_iters,
                        seed=seed, cap_factor=cap_factor, sample=sample,
                        depth=depth, chunk=chunk, opq_iters=opq_iters,
                        anisotropic_t=anisotropic_t,
                        rows_dev=lambda s, c: store.rows_device(
                            s, c, device=dev),
                        rows_sample=rows_sample)

    def _select(self, queries, depth: int, nprobe: int | None, mask):
        p = min(nprobe or self.nprobe, self.n_clusters)
        q = torch.as_tensor(np.asarray(queries, np.float32),
                            device=self.device)
        if q.ndim == 1:
            q = q[None]
        return _adc_select(*self.arrays, q, mask=mask, depth=depth, nprobe=p)

    def search_adc(self, queries, k: int = 10, depth: int | None = None,
                   nprobe: int | None = None, ids: "np.ndarray | None" = None,
                   mask=None):
        """Raw-ADC search: the ranking of the pruned scan itself, no exact
        re-score and no row gather -> ``(scores [B, k], ids [B, k])`` numpy;
        ``ids`` (``[N]``) maps positions to ids (positions without it);
        ``mask``: an optional ``[1, N]`` int8 subset filter on the view's
        device."""
        depth = max(k, depth or self.depth)
        s, pos = self._select(queries, depth, nprobe, mask)
        s, pos = s[:, :k].cpu().numpy(), pos[:, :k].cpu().numpy()
        if s.shape[1] < k:                  # tiny view: fewer probed rows
            padw = ((0, 0), (0, k - s.shape[1]))
            s = np.pad(s, padw, constant_values=-np.inf)
            pos = np.pad(pos, padw, constant_values=-1)
        if ids is not None:
            ids = np.asarray(ids)
            pos = np.where(pos >= 0, ids[np.maximum(pos, 0)], -1)
        return s, pos.astype(np.int32)

    def search_host(self, store: "HostRowStore", queries, k: int = 10,
                    depth: int | None = None, nprobe: int | None = None,
                    mask=None):
        """The capacity cascade: the pruned ADC selection on the view's
        device, then the exact re-score on the host against the memory-
        mapped store (``depth`` rows a query are read) -> ``(scores [B, k],
        ids [B, k])`` numpy with the store's ids (positions without)."""
        q = np.asarray(queries, np.float32)
        if q.ndim == 1:
            q = q[None]
        _, pos = self._select(q, depth or self.depth, nprobe, mask)
        pos = pos.cpu().numpy()                              # [B, dd]
        rows = store.gather(pos)                             # [B, dd, D]
        exact = np.einsum("bkd,bd->bk", rows, q, dtype=np.float32)
        exact = np.where(pos >= 0, exact, -np.inf)
        order = np.argsort(-exact, axis=1, kind="stable")[:, :k]
        s = np.take_along_axis(exact, order, axis=1)
        out_pos = np.take_along_axis(pos, order, axis=1)
        ids = np.where(out_pos >= 0, store.ids_at(out_pos), -1)
        if s.shape[1] < k:
            padw = ((0, 0), (0, k - s.shape[1]))
            s = np.pad(s, padw, constant_values=-np.inf)
            ids = np.pad(ids, padw, constant_values=-1)
        return s.astype(np.float32), ids.astype(np.int32)

    # ------------------------------------------------------------------
    def measure_recall(self, index, queries, k: int = 10,
                       depth: int | None = None,
                       nprobe: int | None = None) -> float:
        """recall@k against the exact ranking, every candidate tier's
        routing off on the exact side."""
        _, exact_ids = index.search(
            queries, index.cfg.search.replace(
                k=k, qe_enabled=False, rerank_enabled=False, ivf_nprobe=0,
                pq_depth=0, ivfpq_nprobe=0))
        _, got = self.search(index, queries, k=k, depth=depth, nprobe=nprobe)
        return recall_vs_exact(exact_ids, got)

    # ------------------------------------------------------------------
    def save(self, path: str) -> None:
        """The reference's form: ``ivfpq.npz`` and ``ivfpq.json``."""
        os.makedirs(path, exist_ok=True)
        arrs = {"centroids": self.centroids, "codes": self.codes,
                "bucket_pos": self.bucket_pos,
                "spill_codes": self.spill_codes, "spill_pos": self.spill_pos,
                "spill_cluster": self.spill_cluster,
                "pq_centroids": self.codebook.centroids}
        if self.rotation is not None:
            arrs["rotation"] = self.rotation
        np.savez(os.path.join(path, "ivfpq.npz"),
                 **{k: v.cpu().numpy() for k, v in arrs.items()})
        with open(os.path.join(path, "ivfpq.json"), "w") as f:
            json.dump({"nprobe": self.nprobe, "depth": self.depth,
                       "anisotropic_t": self.anisotropic_t}, f)

    @classmethod
    def load(cls, path: str, *, device: "torch.device | str | None" = None
             ) -> "IVFPQView":
        """A view saved by :meth:`save` or by the reference, onto
        ``device`` (default: the card, raising without one)."""
        dev = resolve_device(device)
        with open(os.path.join(path, "ivfpq.json")) as f:
            meta = json.load(f)
        raw = np.load(os.path.join(path, "ivfpq.npz"))
        return cls(_put(raw["centroids"], np.float32, dev),
                   _put(raw["codes"], np.int8, dev),
                   _put(raw["bucket_pos"], np.int32, dev),
                   _put(raw["spill_codes"], np.int8, dev),
                   _put(raw["spill_pos"], np.int32, dev),
                   _put(raw["spill_cluster"], np.int32, dev),
                   PQCodebook(_put(raw["pq_centroids"], np.float32, dev)),
                   nprobe=int(meta["nprobe"]), depth=int(meta["depth"]),
                   rotation=(_put(raw["rotation"], np.float32, dev)
                             if "rotation" in raw.files else None),
                   anisotropic_t=meta.get("anisotropic_t"))


class HostRowStore:
    """Memory-mapped host store of the exact rows, for capacity serving: the
    card holds the 32-byte codes, the host the rows, and a query reads only
    its ``depth`` candidates.

    On disk under ``path/``, the reference's form: ``rows.bin`` (``[N, D]``
    row-major in the storage dtype), optional ``scales.bin`` (``[N]`` f32
    row scales of int8 rows), optional ``ids.bin`` (``[N]`` int32; absent,
    ids are positions) and ``store.json``. int8 rows dequantize with their
    scales when read; float rows pass through."""

    def __init__(self, path: str):
        with open(os.path.join(path, "store.json")) as f:
            meta = json.load(f)
        self.n, self.d = int(meta["n"]), int(meta["d"])
        self._dtype = np.dtype(meta["dtype"])
        self.rows = np.memmap(os.path.join(path, "rows.bin"), mode="r",
                              dtype=self._dtype, shape=(self.n, self.d))
        spath = os.path.join(path, "scales.bin")
        # scales and ids are small beside the rows: read whole
        self.scales = (np.fromfile(spath, dtype=np.float32)
                       if os.path.exists(spath) else None)
        ipath = os.path.join(path, "ids.bin")
        self.ids = (np.fromfile(ipath, dtype=np.int32)
                    if os.path.exists(ipath) else None)

    @classmethod
    def create(cls, path: str, rows, scales=None, ids=None,
               dtype: str = "int8", chunk: int = 262_144) -> "HostRowStore":
        """Write a store from ``rows`` ([N, D], any float dtype, or int8 WITH
        their ``scales``). ``dtype='int8'`` with float rows quantizes each
        row symmetrically (scale = max|row| / 127), a chunk at a time."""
        rows = np.asarray(rows)
        n, d = rows.shape
        os.makedirs(path, exist_ok=True)
        out_dtype = np.dtype(dtype)
        mm = np.memmap(os.path.join(path, "rows.bin"), mode="w+",
                       dtype=out_dtype, shape=(n, d))
        if rows.dtype == np.int8:
            if out_dtype != np.int8 or scales is None:
                raise ValueError("int8 input rows need dtype='int8' and "
                                 "their per-row scales")
            mm[:] = rows
        elif out_dtype == np.int8:
            scales = np.empty((n,), np.float32)
            for s in range(0, n, chunk):
                blk = rows[s:s + chunk].astype(np.float32)
                sc = np.abs(blk).max(axis=1) / 127.0
                sc = np.where(sc > 0, sc, 1.0).astype(np.float32)
                scales[s:s + chunk] = sc
                mm[s:s + chunk] = np.clip(
                    np.rint(blk / sc[:, None]), -127, 127).astype(np.int8)
        else:
            for s in range(0, n, chunk):
                mm[s:s + chunk] = rows[s:s + chunk].astype(out_dtype)
        mm.flush()
        del mm
        if scales is not None:
            np.asarray(scales, np.float32).tofile(
                os.path.join(path, "scales.bin"))
        if ids is not None:
            np.asarray(ids, np.int32).tofile(os.path.join(path, "ids.bin"))
        with open(os.path.join(path, "store.json"), "w") as f:
            json.dump({"n": n, "d": d, "dtype": out_dtype.name}, f)
        return cls(path)

    def rows_device(self, start: int, count: int,
                    *, device: "torch.device | str | None" = None
                    ) -> torch.Tensor:
        """Dequantized f32 chunk ``[count, D]`` on ``device`` (default: the
        card, raising without one), zero past N: the raw storage bytes
        move, then dequantize there (int8 moves a quarter of f32's bytes).
        The encode pass's reader."""
        dev = resolve_device(device)
        end = min(start + count, self.n)
        x = torch.from_numpy(np.array(self.rows[start:end])).to(
            dev).float()
        if self.scales is not None:
            x = x * torch.from_numpy(self.scales[start:end]).to(dev)[:, None]
        return torch.nn.functional.pad(x, (0, 0, 0, count - (end - start)))

    def rows_f32(self, start: int, count: int) -> np.ndarray:
        """Dequantized f32 chunk ``[count, D]`` numpy, zero past N."""
        end = min(start + count, self.n)
        blk = np.asarray(self.rows[start:end], np.float32)
        if self.scales is not None:
            blk = blk * self.scales[start:end, None]
        if end - start < count:
            blk = np.pad(blk, ((0, count - (end - start)), (0, 0)))
        return blk

    def gather(self, pos: np.ndarray) -> np.ndarray:
        """Dequantized f32 rows at ``pos [B, n]`` (zeros for pos < 0)."""
        safe = np.maximum(pos, 0)
        rows = np.asarray(self.rows[safe.ravel()], np.float32)
        rows = rows.reshape(*pos.shape, self.d)
        if self.scales is not None:
            rows = rows * self.scales[safe][..., None]
        return np.where((pos >= 0)[..., None], rows, 0.0)

    def ids_at(self, pos: np.ndarray) -> np.ndarray:
        safe = np.maximum(pos, 0)
        return (safe if self.ids is None else self.ids[safe]).astype(
            np.int32)
