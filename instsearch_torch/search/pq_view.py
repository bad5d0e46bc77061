"""PQ compressed-domain cascade: ADC candidate scan, then an exact re-score
(port of ``instsearch_tpu/search/pq_view.py``: ``_pq_candidates``,
``_pq_composite_jit`` and ``PQView``).

Rows are product-quantized to 4-bit codes (``ops/pq.py``, 32 bytes per
512-d row), position-aligned with the index's padded main store. A query's
candidate scan reads only the codes and selects ``depth`` rows, which are
then re-scored exactly against the main store (f32 gather and dot) and
re-sorted: the scan ranks the haystack, the exact tier the needles. With
``depth`` >= the store it is exact search.

Two candidate routes, as in the reference: the fused ADC kernel (K4,
``kernels/pq_scan.py``; its plain version for codes on the CPU), which
sums the bf16-rounded lookup table, and the oracle, which sums the f32
table against a one-hot expansion of the codes over the whole ``[B, N]``
score matrix. The route is the index's own ``cfg.search.use_pallas``. A
subset mask (``search/subset.py``) applies at ADC selection, on both
routes, so the whole depth goes to allowed rows.

The regional re-rank composes by position: it re-ranks the top
``rerank_depth`` of the cascade's exact ranking. ``anisotropic_t`` fits and
encodes the codes under the score-aware loss (``ops/pq.py::fit_apq``).

``Index.add`` is absorbed (``absorb_add`` encodes the new rows with the
frozen codebook at their positions), and so is ``Index.remove``
(``absorb_remove`` replays its compaction moves on the codes). The view
rides ``Index.save``/``load`` in the reference's form (``pq/pq.npz`` with
the unpadded codes, ``pq/pq.json``).
"""
from __future__ import annotations

import json
import math
import os
from functools import partial

import numpy as np
import torch

from ..kernels.pq_scan import pq_topk
from ..kernels.topk_matmul import K_MAX
from ..ops.pq import (PQCodebook, default_m, encode_apq, encode_pq, fit_apq,
                      fit_opq, fit_pq, pq_lut, unpack_pq)
from ..utils.device import resolve_device
from .bruteforce import select_topk
from .qe import expand_from_candidates
from .rerank import rerank_from_candidates

_NEG_INF = float("-inf")
_ORACLE_ROWS = 1 << 16      # rows per one-hot piece on the oracle route


def _oracle_scores(codes: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """``[B, N]`` ADC scores as the reference's oracle computes them: the
    f32 table ``lut [B, M, 16]`` against the one-hot expansion of the codes,
    in pieces of rows so the expansion stays small."""
    b = lut.shape[0]
    flat = lut.reshape(b, -1)                                 # [B, M * 16]
    out = []
    for s in range(0, codes.shape[0], _ORACLE_ROWS):
        oh = torch.nn.functional.one_hot(
            unpack_pq(codes[s:s + _ORACLE_ROWS]).long(), 16).float()
        out.append(flat @ oh.reshape(oh.shape[0], -1).T)
    return torch.cat(out, dim=1)


def _pq_candidates(codes, centroids, rows_f32, q, nv: int, rotation=None,
                   mask=None, *, depth: int, use_kernel: bool):
    """ADC top-``depth`` over the codes, then the exact f32 re-score of
    those rows from the main store and a re-sort -> ``(exact scores
    [B, depth] f32 descending, positions [B, depth] int32, -1 for empty)``.
    ``rows_f32(pos)`` reads the store's rows at positions ``pos [...]``,
    dequantized to f32 ``[..., W]`` (``Index._rows_f32_at``: a placed
    store's from its shards, only those rows). ``codes`` may carry padding
    bytes past M/2 (``PQView.packed``); ``q``
    has the store's width, whose columns past the codebook's are zeros.
    With an OPQ ``rotation`` the scan scores the rotated query; the
    re-score keeps the original one against the unrotated store. A depth
    past the kernel's ``K_MAX`` takes the oracle route. ``mask`` (``[1,
    N]`` int8) restricts the selection to a subset."""
    cb = PQCodebook(centroids)
    q_adc = q[:, :cb.dim]
    if rotation is not None:
        q_adc = (q_adc @ rotation).to(q.dtype)
    if use_kernel and depth <= K_MAX:
        _, pos = pq_topk(codes, q_adc, cb, k=depth, num_valid=nv, mask=mask)
    else:
        s = _oracle_scores(codes[:, :cb.m // 2], pq_lut(q_adc, cb))
        rows_ok = torch.arange(codes.shape[0], device=codes.device) < nv
        if mask is not None:
            rows_ok = rows_ok & (mask.reshape(-1) > 0)
        _, pos = select_topk(s.masked_fill(~rows_ok, _NEG_INF), depth)
    rows = rows_f32(pos.clamp(min=0))
    exact = torch.einsum("bkd,bd->bk", rows, q.float())
    exact = exact.masked_fill(pos < 0, _NEG_INF)
    # re-sort by the exact score, so the QE stage's top-n slice sees the
    # cascade's own ranking; the stable sort keeps the lower slot on ties,
    # as lax.top_k does
    exact, order = torch.sort(exact, dim=1, descending=True, stable=True)
    pos = pos.gather(1, order)
    return exact, torch.where(exact > _NEG_INF, pos, torch.full_like(pos, -1))


def _pq_composite(codes, centroids, rows_f32, ids, q, nv: int,
                  rotation=None, mask=None, regional=None,
                  query_regional=None, vote_matrix=None, *, k: int,
                  depth: int, qe_n: int, qe_alpha: float, do_qe: bool,
                  use_kernel: bool, do_rerank: bool = False,
                  spatial_weight: float = 0.0, rerank_depth: int = 0):
    """The reference's ``_pq_composite_jit``: every candidate selection is
    the ADC-scan -> exact-re-score cascade; the QE rows (``rows_f32``, as
    in :func:`_pq_candidates`) and the re-rank regions (``regional``, the
    regional store or a reader of its rows,
    ``search/rerank.py::region_similarities``) are read from the main
    store by position, the re-rank over the top ``rerank_depth`` of the
    cascade's exact ranking. -> ``(scores [B, k], ids [B, k])``."""
    q = q.float()
    sel = partial(_pq_candidates, codes, centroids, rows_f32,
                  rotation=rotation, mask=mask, depth=depth,
                  use_kernel=use_kernel)
    if do_qe:
        s, pos = sel(q, nv)
        s_n, pos_n = s[:, :qe_n], pos[:, :qe_n]
        rows = rows_f32(pos_n.clamp(min=0))
        rows = torch.where((s_n > _NEG_INF)[..., None], rows,
                           torch.zeros((), device=rows.device))
        q = expand_from_candidates(q, s_n, rows, qe_alpha)
    s, pos = sel(q, nv)
    if do_rerank:
        rd = min(rerank_depth or depth, depth)
        return rerank_from_candidates(
            regional, ids, s[:, :rd], pos[:, :rd], query_regional, k=k,
            spatial_weight=spatial_weight, vote_matrix=vote_matrix)
    out_ids = torch.where(pos >= 0, ids[pos.clamp(min=0).long()],
                          torch.full_like(pos, -1))
    return s[:, :k], out_ids[:, :k]


class PQView:
    """Product-quantized coarse-scan view over an
    :class:`instsearch_torch.index.Index`, on the index's device. Built by
    :meth:`from_index` (or ``Index.build_pq``); ``Index.search`` routes
    through it when ``SearchConfig.pq_depth > 0``. The main store stays
    authoritative: every candidate is re-scored exactly against it, so
    quality depends only on candidate recall (:meth:`measure_recall`)."""

    def __init__(self, codebook: PQCodebook, codes: torch.Tensor,
                 depth: int = 100, rotation: "torch.Tensor | None" = None,
                 anisotropic_t: "float | None" = None):
        self.codebook = codebook        # centroids [M, 16, ds] f32
        # [N_pad, G] int8: the codes' M/2 bytes a row, then zero bytes up
        # to a whole number of 4-byte words, which K4 reads (padded once,
        # here; their subspaces' table rows are zeros, kernels/pq_scan.py)
        pad = -codes.shape[1] % 4
        self.packed = (torch.nn.functional.pad(codes, (0, pad)) if pad
                       else codes)
        self.depth = depth
        self.rotation = rotation        # OPQ rotation [D, D] f32 or None
        self.anisotropic_t = anisotropic_t  # the anisotropic fit's threshold

    @property
    def m(self) -> int:
        return self.codebook.m

    @property
    def bytes_per_row(self) -> int:
        """Code bytes a row, the reference's (without the word padding)."""
        return self.codes.shape[1]

    @property
    def codes(self) -> torch.Tensor:
        """``[N_pad, M/2]`` int8 packed nibbles, the reference's layout (a
        view of ``packed``)."""
        return self.packed[:, :self.m // 2]

    # ------------------------------------------------------------------
    @classmethod
    def from_index(cls, index, m: int | None = None, iters: int = 15,
                   seed: int = 0, sample: "int | None" = 262_144,
                   depth: int = 100, chunk: int = 65_536,
                   opq_iters: int = 0,
                   anisotropic_t: "float | None" = None) -> "PQView":
        """Fit the codebook on the first ``sample`` valid rows (dequantized,
        in contiguous slices) and encode every stored row in ``chunk``-row
        slices, on the index's device. ``m`` defaults to
        ``ops.pq.default_m(D)``; ``opq_iters > 0`` also learns an OPQ
        rotation on the fit sample; ``anisotropic_t`` fits and encodes under
        the score-aware loss instead (``ops.pq.fit_apq``: raw-ADC ranking
        quality; the re-scored cascade gains nothing measurable, as the
        reference notes)."""
        nv = index.num_valid
        d = index.dim
        if m is None:
            m = default_m(d)
        if nv < 16:
            raise ValueError("PQ needs at least 16 indexed rows")

        n_pad = index.n_pad
        chunk = math.gcd(n_pad, max(8, chunk))
        # fit sample: contiguous dequantized slices up to `sample` rows
        fit_rows = min(nv, sample if sample is not None else nv)
        take = []
        got = 0
        for start in range(0, n_pad, chunk):
            if got >= fit_rows:
                break
            sl = index._rows_f32_chunk(start, chunk)
            keep = min(chunk, fit_rows - got, max(0, nv - start))
            if keep <= 0:
                break
            take.append(sl[:keep])
            got += keep
        fit_x = torch.cat(take)
        rot = None
        if anisotropic_t is not None and opq_iters > 0:
            raise ValueError(
                "anisotropic_t and opq_iters are mutually exclusive "
                "(the score-aware alternation is not defined through a "
                "jointly-learned rotation; pick one)")
        if anisotropic_t is not None:
            cb = fit_apq(fit_x, m=m, t=anisotropic_t, init_iters=iters,
                         seed=seed)
        elif opq_iters > 0:
            rot, cb = fit_opq(fit_x, m=m, opq_iters=opq_iters,
                              pq_iters=iters, seed=seed)
        else:
            cb = fit_pq(fit_x, m=m, iters=iters, seed=seed)

        codes = torch.empty((n_pad, m // 2), dtype=torch.int8,
                            device=index.device)
        for start in range(0, n_pad, chunk):
            sl = index._rows_f32_chunk(start, chunk)
            if rot is not None:
                sl = sl @ rot
            codes[start:start + chunk] = (
                encode_apq(sl, cb, t=anisotropic_t)
                if anisotropic_t is not None else encode_pq(sl, cb))
        return cls(cb, codes, depth=depth, rotation=rot,
                   anisotropic_t=anisotropic_t)

    @classmethod
    def from_arrays(cls, centroids, codes, depth: int = 100, rotation=None,
                    device: "torch.device | str | None" = None,
                    anisotropic_t: "float | None" = None) -> "PQView":
        """A view over given state, e.g. a JAX ``PQView``'s
        ``np.asarray(view.codebook.centroids)``, ``view.codes``,
        ``view.rotation`` (None without OPQ) and ``view.anisotropic_t``.
        ``device`` defaults to the card (``utils.device.resolve_device``)."""
        dev = resolve_device(device)

        def put(a, dtype):
            return torch.from_numpy(np.array(a, dtype=dtype)).to(dev)

        rot = None if rotation is None else put(rotation, np.float32)
        return cls(PQCodebook(put(centroids, np.float32)),
                   put(codes, np.int8), depth=depth, rotation=rot,
                   anisotropic_t=anisotropic_t)

    # ------------------------------------------------------------------
    def absorb_add(self, index, start: int, n_new: int) -> None:
        """Absorb the rows ``[start, start + n_new)`` just written to the
        main store: encode them with the frozen codebook (and rotation, or
        the anisotropic loss of the fit) into ``packed``, the array K4
        scans (``codes`` is a view of it), which first grows with zero rows
        when the add re-padded the store. The reference's window: the next power of two at least ``n_new``
        (at least 8) rows from ``start``, moved back when it would run past
        the store, all re-encoded; rows before ``start`` encode as they
        did, so the codes stay the reference's byte for byte."""
        n_pad = index.n_pad
        if self.packed.shape[0] != n_pad:
            grown = self.packed.new_zeros((n_pad, self.packed.shape[1]))
            grown[:self.packed.shape[0]] = self.packed
            self.packed = grown
        p = max(8, 1 << max(0, n_new - 1).bit_length())
        s0 = 0 if p >= n_pad else min(start, n_pad - p)
        rows = index._rows_f32_chunk(s0, min(p, n_pad))
        if self.rotation is not None:
            rows = rows @ self.rotation
        self.packed[s0:s0 + rows.shape[0], :self.m // 2] = (
            encode_apq(rows, self.codebook, t=self.anisotropic_t)
            if self.anisotropic_t is not None
            else encode_pq(rows, self.codebook))

    def absorb_remove(self, src: torch.Tensor, dst: torch.Tensor) -> None:
        """Replay ``Index.remove``'s compaction moves (rows ``src`` to
        ``dst``, gathered before any write) on the position-aligned codes;
        codes past ``num_valid`` are masked by the scan's bound."""
        self.packed[dst] = self.packed[src]

    def save(self, path: str) -> None:
        """The reference's form: ``pq.npz`` (``centroids``, the unpadded
        ``codes [N_pad, M/2]``, ``rotation`` with OPQ) and ``pq.json``."""
        os.makedirs(path, exist_ok=True)
        arrs = {"centroids": self.codebook.centroids.cpu().numpy(),
                "codes": self.codes.cpu().numpy()}
        if self.rotation is not None:
            arrs["rotation"] = self.rotation.cpu().numpy()
        np.savez(os.path.join(path, "pq.npz"), **arrs)
        with open(os.path.join(path, "pq.json"), "w") as f:
            json.dump({"depth": self.depth,
                       "anisotropic_t": self.anisotropic_t}, f)

    @classmethod
    def load(cls, path: str, *, device: "torch.device | str | None" = None
             ) -> "PQView":
        """A view saved by :meth:`save` or by the reference; its codes are
        padded to words again. ``device`` defaults to the card."""
        with open(os.path.join(path, "pq.json")) as f:
            meta = json.load(f)
        raw = np.load(os.path.join(path, "pq.npz"))
        return cls.from_arrays(
            raw["centroids"], raw["codes"], depth=int(meta["depth"]),
            rotation=raw["rotation"] if "rotation" in raw.files else None,
            device=device, anisotropic_t=meta.get("anisotropic_t"))

    # ------------------------------------------------------------------
    def candidates(self, index, queries, depth: int | None = None,
                   use_pallas: bool | None = None):
        """``(exact scores [B, depth], row positions [B, depth])``, the
        cascade stage already re-scored. ``use_pallas``: True scans with K4
        (on a CUDA store; a CPU tensor takes its plain version), False with
        the plain scan, None on the route of the index's own
        ``cfg.search.use_pallas``. A placed index (``Index.load(mesh=)``)
        stays placed: the re-score reads its candidates' rows from the
        shards (across processes, collectively: every process calls this
        with the same queries)."""
        depth = min(depth or self.depth, self.codes.shape[0])
        q = torch.as_tensor(queries, device=index.device).float()
        if q.ndim == 1:
            q = q[None]
        q = index._match_query_dim(q)
        return _pq_candidates(
            self.packed, self.codebook.centroids, index._rows_f32_at, q,
            index.num_valid, self.rotation, depth=depth,
            use_kernel=bool(index.cfg.search.use_pallas
                            if use_pallas is None else use_pallas))

    def search(self, index, queries, k: int = 10, depth: int | None = None):
        """Descriptor-space cascade search -> ``(scores [B, k], dataset ids
        [B, k])`` numpy arrays, as ``Index.search`` returns."""
        s, pos = self.candidates(index, queries, depth)
        ids = torch.where(pos >= 0, index.ids[pos.clamp(min=0).long()],
                          torch.full_like(pos, -1))
        return s[:, :k].cpu().numpy(), ids[:, :k].cpu().numpy()

    def measure_recall(self, index, queries, k: int = 10,
                       depth: int | None = None) -> float:
        """recall@k against the exact brute-force ranking: the build-time
        honesty number for a chosen cascade depth."""
        _, exact_ids = index.search(
            queries, index.cfg.search.replace(k=k, qe_enabled=False,
                                              rerank_enabled=False,
                                              pq_depth=0))
        _, pq_ids = self.search(index, queries, k=k, depth=depth)
        hits = total = 0
        for e, a in zip(exact_ids, pq_ids):
            es = set(int(i) for i in e if i >= 0)
            if not es:
                continue
            hits += len(es & set(int(i) for i in a if i >= 0))
            total += len(es)
        return hits / max(total, 1)
