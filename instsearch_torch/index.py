"""The Index: device-resident descriptor store + query/evaluate API (port of
``instsearch_tpu/index.py``, the single-device slice over bf16, f32, int8 and
int4 stores, with the PQ cascade view).

Storage layout is the reference's: rows padded to a multiple of
``row_tile * num_shards`` (and up to ``capacity``), padding rows carrying
id -1 so they never enter a top-k. The store is bf16 or f32, or int8 rows /
packed int4 nibble pairs (``ops/quantize.py``) with f32 row ``scales [1,
N_pad]``, quantized from the f32 padded rows as the reference does. Each
row also carries zero columns up to the width the Hopper kernels read
(``_COLUMN_MULTIPLE``; ``dim`` stays the descriptor width): they change no
score and no row scale, so the stored components up to ``dim`` equal the
reference's for the same rows (int4 packs a row's two halves into one byte,
so there the bytes pair other components). A ``k`` past the kernels'
``K_MAX`` takes the scoring oracle, as a ``k`` past the reference's tile
does.

Search goes through the fused top-k kernels (``kernels/topk_matmul.py``:
K1 for float stores, K2 for int8, K3 for int4): on a CUDA store with the
index's own ``cfg.search.use_pallas`` (the presets' default) those are the
hand-written Hopper kernels; on a CPU store their plain versions. With the
index's ``use_pallas`` off, the brute-force scoring oracle ranks instead,
as in the reference, which reads the index's own config too. Alpha query
expansion (``qe_enabled``) runs the reference's composite: the kernel's
top-``qe_n``, the rows gathered and dequantized, the expanded query, the
kernel's final top-k.

Regional re-ranking (``rerank_enabled``, ``search/rerank.py``) runs the
reference's re-rank stage: the kernel's top-``rerank_depth`` candidates,
their R-MAC regions gathered from the regional store ``[N_pad, R, D]``
(``attach_regional_store``), matched against the query's regions and fused
with the global score, plus the spatial vote when ``spatial_weight > 0``
(``search/spatial.py``). The exact-refine tier (``refine_dtype="int8"``
over an int4 store, ``refine_enabled``) is the same stage over a one-region
int8 copy of the original rows, with the query as its one region and no
global term.

``build_pq`` attaches a PQ view (``search/pq_view.py``): with
``cfg.search.pq_depth > 0`` every top-k selection above becomes the cascade
of an ADC scan over 4-bit codes (K4, ``kernels/pq_scan.py``, on the kernel
route) and an exact re-score of its ``depth`` candidates against the store.
The ANN tiers are views too, one candidate tier per index: ``build_ivf``
(``search/ivf.py``, ``ivf_nprobe``) scans only the probed k-means buckets
of rows, ``build_ivfpq`` (``search/ivfpq.py``, ``ivfpq_nprobe``) the probed
buckets of 4-bit residual codes, then re-scores exactly; both run plain
PyTorch (no Pallas kernel in the reference either), launch none of K1-K4,
and absorb ``add`` and ``remove``.

``to_sharded`` cuts the store into ``num_shards`` row shards over a shard
mesh (``parallel/``); ``query_images(sharded_index=...)``,
``evaluate(sharded=True)`` and ``ServeCore(sharded=True)`` route through it.

The index lives: ``make_subset`` builds an allow-list (``search/subset.py``)
that every top-k above takes as the kernels' ``[1, N_pad]`` mask;
``search_range`` returns every row scoring at least a threshold with its
exact count; ``reconstruct`` reads stored rows back; ``add`` writes rows in
place (re-padding past capacity), ``remove`` compacts the store by moving
tail rows into the holes, ``merge_from`` adds another index's rows, each
exactly as the reference moves and quantizes them, the PQ view absorbing
both. ``save``/``load`` take two forms of the store (below).

The quality tiers: ``augment_database`` (αDBA, ``search/dba.py``; applied
by ``build`` when ``cfg.index.dba_n``) replaces every stored row by the
weighted sum of its nearest rows, found chunk by chunk through the same
top-k kernels as serving; ``diffusion_enabled`` re-ranks the kernel's
top-``diffusion_depth`` by diffusion on their mutual-kNN graph
(``search/diffusion.py``); ``fit_local_whitening`` attaches a
local-whitening view (``search/lw_rerank.py``) that ``lw_enabled``
re-scores the top-``rerank_depth`` under. ``knn_graph`` runs the same
chunked self-search for every row's neighbours, ``find_duplicates`` groups
rows above a score, ``stats`` describes the stores.

``metric="l2"`` (raw vectors, the FAISS ``IndexFlatL2`` counterpart) stores
each row with one more column, ``||x||^2/2``, at column ``dim - 1`` (``dim``
counts it, as the reference's does; the zero columns come after it), and
queries gain a ``-1`` there, so the same inner-product kernels rank by
Euclidean distance; scores come back as ``-||x - q||^2`` and range radii
become per-query thresholds. The cosine-space stages refuse an l2 index.

``load(mesh=)`` places the store shard by shard: each shard's rows of the
store, its row scales and regional store go to its device, held by one
``ShardedIndex`` (``Index.placement``), and the index's own store
attributes stay None. Serving (``search``, ``query``, ``search_range``,
``knn_graph``, ``find_duplicates``, ``full_ranking``, ``reconstruct``,
``evaluate``, ``stats``, ``save``) runs through that placement
(``to_sharded`` with the same mesh reuses its tensors). The placed store is
mutated where it lies, as the reference's sharded arrays are: ``add``
within capacity, ``remove``, ``merge_from``, the views absorbing both, and
the views' fits (``build_pq``, ``build_ivf``, ``build_ivfpq``,
``fit_local_whitening``) read and write rows through the placement
(``ShardedIndex.read_rows``/``write_rows``), each shard writing only its
own rows, scales, regional rows and valid count; across processes only the
rows that move cross (one ``all_gather``), and the fits, which read every
row, gather the store first. The views stay whole on the mesh's first
device, where ``load(mesh=)`` puts them. Three operations still call
``Index.gather``, which joins the shards onto the mesh's first device
(the index is an unplaced one from then on, and that device must hold the
whole store), because the reference's own result leaves the placement
there too: ``augment_database`` (the reference's store comes back
replicated), ``attach_regional_store`` (its regional store lands on one
device) and an ``add`` past capacity (its re-pad lands on one device;
across processes it raises instead). So does ``to_sharded`` onto another
mesh. A search through an armed candidate tier (IVF, PQ, IVF-PQ) keeps the
placement, as the reference's does: the tier's view scans on the first
device, and its exact re-score, αQE and regional re-rank read only their
candidates' rows from the shards (``Index._rows_f32_at``,
``Index._regions_at``; across processes through the collective
``ShardedIndex.read_rows``).

Persistence. ``save`` writes a directory: ``meta.json`` (names, config,
``format``, the arrays' dtypes, the views present), the views' own
directories (``ivf/``, ``lw/``, ``pq/``, ``ivfpq/``, the reference's forms),
the backbone's ``torch_weights.pt``, and the store in one of two forms,
each holding the reference's arrays (``ids``, ``descriptors`` /
``descriptors_int8`` / ``descriptors_int4``, ``scales``, ``whitening_P`` /
``whitening_mu``, ``regional`` / ``regional_int8``, ``regional_scales``) at
the reference's width and int4 pairing:
  * ``format: "npy_stream"``, the port's stream: ``store/`` is a sharded
    tree (``utils/checkpoint.py``), one ``.npy`` file an array in its
    storage dtype (bf16 as its ``uint16`` bits, not widened) and
    ``tree.json``. A placed store writes each shard's rows from its own
    part, and ``load(mesh=)`` reads each shard's rows alone from a memory
    map, so neither holds more than one shard's rows on the host. The
    reference cannot read this form (it reads npz and orbax only).
  * ``format: "npz"``: ``index.npz``, bf16 widened to f32, the form the
    reference writes below its streaming cutoff and reads; each package
    reads what the other writes in it.
``save(streaming=None)`` takes the stream when the arrays hold at least 8
MiB (the regional store counted), as the reference takes its orbax form;
``streaming=True``/``False`` force the choice. The reference's own stream
(``format: "orbax"``, OCDBT under ``store/``) and its orbax ``variables/``
need tensorstore: ``tools/orbax_to_port.py``, run where JAX and orbax are
installed, converts such an index to the port's stream, and ``load``
refuses one unconverted.
"""
from __future__ import annotations

import json
import logging
import os
from typing import Optional, Sequence

import numpy as np
import torch

from .config import PipelineConfig
from .extractor import Extractor
from .kernels.topk_matmul import (K_MAX, topk_matmul, topk_matmul_int4,
                                  topk_matmul_int8)
from .ops.quantize import (pack_int4, quantize_rows, quantize_rows_int4,
                           unpack_int4)
from .ops.whitening import (WhiteningParams, apply_whitening,
                            apply_whitening_regional, fit_whitening)
from .search.bruteforce import gather_rows_f32 as _gather_rows_f32
from .search.bruteforce import (masked_scores, range_count, search_topk,
                                select_topk)
from .search.diffusion import diffusion_rerank_from_candidates
from .search.ivf import IVFIndex, _ivf_composite
from .search.ivfpq import IVFPQView, _ivfpq_composite
from .search.lw_rerank import (LocalWhiteningView, lw_rescore_from_candidates,
                               whiten_all_clusters)
from .search.pq_view import PQView, _pq_composite
from .search.qe import expand_from_candidates
from .search.rerank import rerank_from_candidates
from .search.spatial import build_vote_matrix
from .search.subset import SubsetFilter, build_position_mask
from .utils.checkpoint import CONVERTER as _CONVERTER
from .utils.checkpoint import WEIGHTS_FILE as _WEIGHTS_FILE
from .utils.checkpoint import (Placed, open_tree, save_sharded_pytree,
                               tensor_of)
from .utils.chunking import run_chunked
from .utils.device import resolve_device
from .utils.observe import COUNTERS

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
_QUANTIZE = {"int8": quantize_rows, "int4": quantize_rows_int4}
# stored rows carry zero columns up to a multiple of these widths, the ones
# the K1-K3 kernels take (they read rows as 16-byte vectors: D % 8 for
# bf16/f32, 16 int8 values, 32 int4 values); a zero column changes no dot
# product and no int8/int4 row scale
_COLUMN_MULTIPLE = {"bfloat16": 8, "float32": 8, "int8": 16, "int4": 32}


def _pad_rows(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def _topk_raw(descriptors, ids, queries, num_valid: int, scales, *, k: int,
              use_kernel: bool, int4: bool = False, mask=None):
    """``(scores [Q, k], pos [Q, k])`` with pos indexing the padded store;
    invalid slots are ``(-inf, -1)``. The fused kernel of the store's kind
    (int4 -> K3, int8 -> K2, float -> K1; for a CPU store its plain
    version) when ``use_kernel``; the scoring oracle otherwise, and for a
    k past the kernels' ``K_MAX``, as the reference routes a k past its
    tile. ``mask`` (``[1, N_pad]`` int8, ``search/subset.py``) restricts
    the selection to a subset: the kernels' mask operand, the oracle's
    padding mask."""
    if not use_kernel or k > K_MAX:
        return search_topk(descriptors, queries, k=k, ids=ids, scales=scales,
                           int4=int4, mask=mask)
    if int4:
        return topk_matmul_int4(descriptors, scales, queries, k=k,
                                num_valid=num_valid, mask=mask)
    if descriptors.dtype == torch.int8:
        return topk_matmul_int8(descriptors, scales, queries, k=k,
                                num_valid=num_valid, mask=mask)
    return topk_matmul(descriptors, queries, k=k, num_valid=num_valid,
                       mask=mask)


def _pos_to_ids(ids, scores, pos):
    valid = (pos >= 0) & (scores > float("-inf"))
    return torch.where(valid, ids[pos.clamp(min=0).long()],
                       torch.full_like(pos, -1))


def _expand(descriptors, ids, q, num_valid, scales, *, qe_n, qe_alpha,
            use_kernel, int4, mask=None, include_query: bool = True):
    """The alpha-QE stage of the composites, and αDBA's weighting with
    ``include_query=False``: fused top-``qe_n``, the rows gathered and
    dequantized, the expanded query."""
    s, pos = _topk_raw(descriptors, ids, q, num_valid, scales, k=qe_n,
                       use_kernel=use_kernel, int4=int4, mask=mask)
    rows = _gather_rows_f32(descriptors, pos.clamp(min=0), scales,
                            int4=int4)                         # [Q, n, D]
    rows = torch.where((s > float("-inf"))[..., None], rows,
                       torch.zeros((), device=rows.device))
    return expand_from_candidates(q, s, rows, qe_alpha,
                                  include_query=include_query)


def _search_composite(descriptors, ids, queries, num_valid: int, scales,
                      regional=None, regional_scales=None,
                      query_regional=None, vote_matrix=None, *, k: int,
                      qe_n: int, qe_alpha: float, use_kernel: bool,
                      do_qe: bool, int4: bool = False, depth: int = 0,
                      do_rerank: bool = False, do_refine: bool = False,
                      spatial_weight: float = 0.0, mask=None,
                      do_diffusion: bool = False, diff_knn: int = 10,
                      diff_alpha: float = 0.99, diff_iters: int = 20,
                      diff_seeds: int = 10):
    """The reference's ``_search_composite_jit``: optional alpha-QE (fused
    top-``qe_n``, the rows gathered and dequantized, expanded query), then
    the re-rank stage (fused top-``depth`` candidates re-scored against the
    ``regional`` store by ``rerank_from_candidates``; refine takes the query
    itself as its one region and drops the global term, fuse weight 0), or
    the diffusion stage (fused top-``depth`` candidates, their rows
    gathered, re-ranked by ``diffusion_rerank_from_candidates``), or the
    final top-k -> ``(scores [Q, k], ids [Q, k])``. No ``[Q, N]`` matrix on
    the kernel route. A subset ``mask`` reaches every top-k."""
    q = queries.float()
    if do_qe:
        q = _expand(descriptors, ids, q, num_valid, scales, qe_n=qe_n,
                    qe_alpha=qe_alpha, use_kernel=use_kernel, int4=int4,
                    mask=mask)
    if do_rerank or do_refine:
        g, pos = _topk_raw(descriptors, ids, q, num_valid, scales, k=depth,
                           use_kernel=use_kernel, int4=int4, mask=mask)
        # refine: the row copy is the one "region" and the (post-QE) query,
        # without the store's zero columns, the one query region
        qreg = q[:, None, :regional.shape[-1]] if do_refine else query_regional
        return rerank_from_candidates(
            regional, ids, g, pos, qreg, k=k, regional_scales=regional_scales,
            fuse_weight=0.0 if do_refine else 1.0,
            spatial_weight=spatial_weight, vote_matrix=vote_matrix)
    if do_diffusion:
        g, pos = _topk_raw(descriptors, ids, q, num_valid, scales, k=depth,
                           use_kernel=use_kernel, int4=int4, mask=mask)
        cand = _gather_rows_f32(descriptors, pos.clamp(min=0), scales,
                                int4=int4)                     # [Q, depth, D]
        return diffusion_rerank_from_candidates(
            ids, g, pos, cand, k=k, knn=diff_knn, alpha=diff_alpha,
            iters=diff_iters, seeds=diff_seeds)
    scores, pos = _topk_raw(descriptors, ids, q, num_valid, scales, k=k,
                            use_kernel=use_kernel, int4=int4, mask=mask)
    return scores, _pos_to_ids(ids, scores, pos)


def _lw_composite(descriptors, ids, queries, num_valid: int, scales, lw,
                  mask=None, *, k: int, depth: int, qe_n: int,
                  qe_alpha: float, use_kernel: bool, do_qe: bool,
                  int4: bool = False):
    """The reference's ``_lw_composite_jit``: optional alpha-QE, the fused
    top-``depth`` candidates, the (post-QE) query whitened by every expert
    of the view ``lw`` (at the bank's width: the store's zero columns
    dropped), the candidates re-scored from the whitened store, top-k."""
    q = queries.float()
    if do_qe:
        q = _expand(descriptors, ids, q, num_valid, scales, qe_n=qe_n,
                    qe_alpha=qe_alpha, use_kernel=use_kernel, int4=int4,
                    mask=mask)
    g, pos = _topk_raw(descriptors, ids, q, num_valid, scales, k=depth,
                       use_kernel=use_kernel, int4=int4, mask=mask)
    q_all = whiten_all_clusters(q[:, :lw.params.mu.shape[-1]], lw.params.P,
                                lw.params.mu)
    return lw_rescore_from_candidates(lw.store, lw.assign, ids, g, pos,
                                      q_all, k=k)


def _extractor_fingerprint(ex) -> list:
    """Equality fingerprint of an extractor's weights and whitening: per
    tensor (in ``state_dict`` order) its shape and f64 sum. The guard of
    ``merge_from`` against uniting stores of different models or
    whitenings, not against collisions made on purpose."""
    out = [(tuple(t.shape), float(t.double().sum()))
           for t in ex.model.state_dict().values()]
    if ex.whitening is not None:
        out += [("whitening", tuple(t.shape), float(t.double().sum()))
                for t in ex.whitening]
    return out


def _check_index_cfg(cfg) -> None:
    """Raise ``ValueError`` for an index option the port does not take."""
    icfg = cfg.index
    if icfg.metric not in ("ip", "l2"):
        raise ValueError(f"metric={icfg.metric!r}: 'ip' or 'l2'")
    if icfg.dtype not in _DTYPES and icfg.dtype not in _QUANTIZE:
        raise ValueError(f"index dtype {icfg.dtype!r}: bfloat16, float32, "
                         f"int8 or int4")
    if icfg.metric == "l2" and icfg.dtype == "int4":
        raise ValueError(
            "metric='l2' does not support int4 storage (the "
            "norm-augmentation column and nibble packing interact; use "
            "int8/bfloat16/float32)")
    if icfg.refine_dtype:
        if icfg.refine_dtype != "int8":
            raise ValueError(f"refine_dtype={icfg.refine_dtype!r}: only "
                             f"'int8' is supported")
        if icfg.dtype != "int4":
            raise ValueError(
                "refine_dtype only makes sense over int4 storage "
                "(int8/bf16 scans already score at refine precision)")
        if cfg.search.rerank_enabled:
            raise ValueError(
                "refine_dtype and rerank_enabled both claim the "
                "regional-store slot; pick one re-scoring stage")


def attach_regional_store(idx: "Index", regional, *, chunk: int = 1 << 16
                          ) -> None:
    """Pad the ``[N, R, D]`` regional rows (numpy, or a tensor on any
    device; one per indexed image, in its order) into the index's ``[N_pad,
    R, D]`` re-rank store on the index's device, in the store's dtype; an
    int8 or int4 index quantizes them per (row, region) with
    ``quantize_rows`` over the flattened padded rows, as the reference (an
    int4 index keeps an int8 regional store: rows are gathered per
    candidate, not streamed, and re-ranking is precision-sensitive). Rows
    move and convert ``chunk`` at a time, so the store is never built
    through a whole host or f32 copy. Records the R-MAC grid's geometry
    (spatial verification) when the extractor's grid has R regions and the
    store is not the exact-refine copy. A placed index (``load(mesh=)``)
    is gathered first: the reference's regional store lands on one device
    too."""
    idx.gather()
    reg = torch.as_tensor(regional)
    n, r, d = reg.shape
    if n != idx.num_valid:
        raise ValueError(f"{n} regional rows for {idx.num_valid} indexed "
                         f"images")
    n_pad, dev = idx.descriptors.shape[0], idx.device
    if idx.cfg.index.dtype in _QUANTIZE:
        store = torch.empty((n_pad, r, d), dtype=torch.int8, device=dev)
        scales = torch.empty((n_pad, r), dtype=torch.float32, device=dev)
        for i in range(0, n_pad, chunk):
            part = reg[i:i + chunk]
            rows = torch.zeros((min(chunk, n_pad - i), r, d),
                               dtype=torch.float32, device=dev)
            rows[:len(part)] = part.to(dev)
            qr = quantize_rows(rows.reshape(-1, d))
            store[i:i + chunk] = qr.values.reshape(-1, r, d)
            scales[i:i + chunk] = qr.scales.reshape(-1, r)
    else:
        store = torch.zeros((n_pad, r, d), dtype=_DTYPES[idx.cfg.index.dtype],
                            device=dev)
        for i in range(0, n, chunk):
            part = reg[i:i + chunk]
            store[i:i + len(part)] = part.to(dev, store.dtype)
        scales = None
    idx.regional, idx.regional_scales = store, scales
    idx.regional_geom, idx._vote_m = None, None
    if idx.extractor is not None and not idx.cfg.index.refine_dtype:
        geom = idx.extractor.regional_geometry()
        if len(geom) == r:
            idx.regional_geom = geom


def _l2_scores(s: np.ndarray, i: np.ndarray, qn2: np.ndarray) -> np.ndarray:
    """An l2 index's augmented inner products -> ``-||x - q||^2 = 2 s -
    ||q||^2`` (empty slots stay -inf), in f32 as the reference."""
    return np.where(i >= 0, 2.0 * s - qn2[:, None], -np.inf).astype(
        np.float32)


# the store tensors: Index attribute -> (the Shard field that holds a placed
# store's part of it, the dimension the rows run along)
_STORES = {"descriptors": ("x", 0), "scales": ("scales", 1),
           "regional": ("regional", 0),
           "regional_scales": ("regional_scales", 0)}


def _leaf_dtype(v) -> str:
    """The storage dtype's name of an array of ``Index._array_state``."""
    t = v.parts[0] if isinstance(v, Placed) else v
    return str(t.dtype).split(".")[-1]


def _leaf_bytes(v) -> int:
    """Bytes of an array of ``Index._array_state`` in its storage dtype (a
    placed one's over every shard), as the reference counts its arrays."""
    if isinstance(v, Placed):
        n = v.mesh.num_shards if v.mesh is not None else len(v.parts)
        return n * v.parts[0].numel() * v.parts[0].element_size()
    return v.numel() * v.element_size()


class Index:
    """Brute-force cosine index over L2-normalized descriptors (or, with
    ``metric="l2"``, Euclidean over raw vectors)."""

    def __init__(self, descriptors: torch.Tensor, ids: torch.Tensor,
                 names: list[str], cfg, extractor: Optional[Extractor] = None,
                 regional: "torch.Tensor | None" = None,
                 scales: "torch.Tensor | None" = None, *,
                 dim: "int | None" = None):
        # load(mesh=)'s placed store (a ShardedIndex); the store
        # attributes below are then None
        self.placement = None
        self.descriptors = descriptors      # [N_pad, W] (int4: [N_pad, W/2])
        self.ids = ids                      # [N_pad] int32, -1 = padding
        self.names = names                  # len = num_valid
        self.cfg = cfg
        self.extractor = extractor
        self.scales = scales                # [1, N_pad] f32 for int8/int4
        self.pq: "PQView | None" = None     # build_pq's cascade view
        self.ivf: "IVFIndex | None" = None  # build_ivf's ANN view
        self.ivfpq: "IVFPQView | None" = None   # build_ivfpq's cascade view
        self.lw: "LocalWhiteningView | None" = None  # fit_local_whitening's
        if regional is not None:
            regional = torch.as_tensor(regional, device=ids.device)
        self.regional: "torch.Tensor | None" = regional  # [N_pad, R, D]
        # [N_pad, R] when the regional store is int8: attach_regional_store
        # quantizes and sets them; a store given here keeps its own dtype
        # and has none, as the reference's constructor
        self.regional_scales: "torch.Tensor | None" = None
        self.regional_geom: "np.ndarray | None" = None  # [R, 3] R-MAC grid
        self._vote_m: "torch.Tensor | None" = None
        self.quarantined: list[str] = []
        # the descriptor width; the store's W may add zero columns past it
        self._dim = self.store_dim if dim is None else dim
        # bumped whenever row positions move (remove) or the store re-pads
        # (add past capacity): SubsetFilters of another generation are stale
        self._layout_gen = 0

    # ------------------------------------------------------------------
    @property
    def num_valid(self) -> int:
        return len(self.names)

    @property
    def is_int4(self) -> bool:
        """Packed-nibble storage: the store is [N_pad, D/2] int8, which its
        dtype cannot tell from int8 rows."""
        return self.cfg.index.dtype == "int4"

    @property
    def is_l2(self) -> bool:
        """Euclidean-metric index (``IndexConfig.metric="l2"``): rows carry
        one ``||x||^2/2`` column (counted in ``dim``), queries gain a
        ``-1`` there, the inner-product kernels rank by ``-||x - q||``;
        scores come back as ``-||x - q||^2``."""
        return self.cfg.index.metric == "l2"

    @property
    def dim(self) -> int:
        """The descriptor width, the reference's ``dim`` (an odd width
        stored as int4 counts its zero column, an l2 store its norm column,
        as there)."""
        return self._dim

    @property
    def user_dim(self) -> int:
        """The width of the caller's rows and queries: ``dim`` without an
        l2 store's norm column."""
        return self._dim - (1 if self.is_l2 else 0)

    @property
    def store_dim(self) -> int:
        """Columns of a stored row, ``dim`` and the zero columns up to the
        kernels' multiple (``_COLUMN_MULTIPLE``)."""
        if self.placed:
            return self.placement.store_dim
        x = self.descriptors
        return 2 * x.shape[1] if self.is_int4 else x.shape[1]

    @property
    def store_dtype(self) -> torch.dtype:
        """The stored rows' dtype (a placed store's, its shards')."""
        if self.placed:
            return self.placement.shards[0].x.dtype
        return self.descriptors.dtype

    @property
    def n_pad(self) -> int:
        """Rows of the padded store."""
        if self.placed:
            return self.placement.num_rows
        return self.descriptors.shape[0]

    @property
    def device(self) -> torch.device:
        """The store's device, where its ids are (a placed store's: its
        mesh's first, with the ids and the views)."""
        return self.ids.device

    @property
    def placed(self) -> bool:
        """The store lies in ``placement``'s shards (``load(mesh=)``), not
        yet gathered by a whole-store operation."""
        return self.placement is not None

    @property
    def has_regional(self) -> bool:
        """A regional store (R-MAC re-rank rows or the exact-refine copy)
        is attached, placed or not."""
        if self.placed:
            return self.placement.regional is not None
        return self.regional is not None

    @property
    def regions_per_image(self) -> "int | None":
        """R of the regional store ``[N_pad, R, D]``, or None without
        one."""
        if not self.has_regional:
            return None
        reg = self._parts("regional")[0] if self.placed else self.regional
        return int(reg.shape[1])

    def _parts(self, name: str) -> "list | None":
        """A placed store's ``name`` (a key of ``_STORES``): one tensor per
        local shard, or None for an absent store."""
        field = _STORES[name][0]
        parts = [getattr(sh, field) for sh in self.placement.shards]
        return None if parts[0] is None else parts

    def gather(self) -> None:
        """Join a placed store (``load(mesh=)``) onto its mesh's first
        device: every shard's rows, row scales and regional store (through
        the mesh's group when it has one, so every process gets the whole
        store). The index is an unplaced one from then on. Serving (the
        candidate tiers' searches included: they read their candidates'
        rows from the shards) and the mutations within capacity never call
        it; ``augment_database``, ``attach_regional_store`` and an ``add``
        past capacity do, since the reference's own results leave its
        placement there, as does, across processes, a view's fit. A no-op
        on an unplaced index."""
        if not self.placed:
            return
        logging.getLogger("instsearch.index").info(
            "gathering the placed store onto %s for a whole-store operation",
            self.device)
        joined = {name: None if self._parts(name) is None else
                  self.placement.mesh.gather(self._parts(name), dim)
                  for name, (_, dim) in _STORES.items()}
        self.placement = None
        for name, t in joined.items():
            setattr(self, name, t)

    def _fit_prologue(self) -> None:
        """Before a view's fit: a store placed across processes is gathered
        (the fit reads every row); a store placed in one process is read
        through its placement."""
        if self.placed and self.placement.mesh.group is not None:
            self.gather()

    def _replace_placement(self) -> None:
        """After a mutation of a placed store: the placement anew over the
        same parts (nothing copied) with the index's ids, so every shard's
        valid count is the new one, and the views' current state (the
        local-whitening rows cut again, the IVF-PQ view attached again)."""
        p = self.placement
        self.placement = self._sharded_view(
            p.mesh, {name: self._parts(name) for name in _STORES},
            p.use_pallas)

    def _stored_rows(self, pos: torch.Tensor):
        """Stored rows at padded positions ``pos [...]`` (non-negative),
        verbatim in the store's dtype -> ``(rows [..., W], row scales [...]
        f32 or None)`` on the index's device; a placed store's through its
        placement (``ShardedIndex.read_rows``)."""
        if not self.placed:
            p = pos.long()
            return (self.descriptors[p],
                    None if self.scales is None else self.scales[0][p])
        v = self.placement.read_rows(pos.reshape(-1), ("x", "scales"))
        sc = v.get("scales")
        return (v["x"].reshape(tuple(pos.shape) + tuple(v["x"].shape[1:])),
                None if sc is None else sc.reshape(pos.shape))

    def _rows_f32_at(self, pos: torch.Tensor) -> torch.Tensor:
        """Stored rows at padded positions ``pos [...]`` (non-negative),
        dequantized to f32 ``[..., W]`` as every search stage gathers them:
        the candidate tiers' row reader. A placed store's are read through
        its placement (``ShardedIndex.rows_f32``: only these rows, and
        across processes collectively)."""
        if self.placed:
            rows = self.placement.rows_f32(pos.reshape(-1))
            return rows.reshape(tuple(pos.shape) + tuple(rows.shape[1:]))
        return _gather_rows_f32(self.descriptors, pos, self.scales,
                                int4=self.is_int4)

    def _regions_at(self, pos: torch.Tensor):
        """Regional rows at padded positions ``pos [...]`` (non-negative),
        verbatim in the store's dtype -> ``(regions [..., R, D], their
        scales [..., R] f32 or None)``: the re-rank's reader
        (``search/rerank.py::region_similarities``). A placed store's are
        read through its placement (``ShardedIndex.read_rows``)."""
        if not self.placed:
            p = pos.long()
            return (self.regional[p], None if self.regional_scales is None
                    else self.regional_scales[p])
        v = self.placement.read_rows(pos.reshape(-1),
                                     ("regional", "regional_scales"))
        reg, sc = v["regional"], v.get("regional_scales")
        shape = tuple(pos.shape)
        return (reg.reshape(shape + tuple(reg.shape[1:])), None if sc is None
                else sc.reshape(shape + tuple(sc.shape[1:])))

    def _regional_f32(self, start: int, count: int) -> torch.Tensor:
        """Regional rows ``[start, start + count)``, dequantized to f32
        ``[count, R, D]``; a placed store's through its placement."""
        reg, sc = self._regions_at(torch.arange(start, start + count,
                                                device=self.device))
        reg = reg.float()
        return reg if sc is None else reg * sc[:, :, None]

    @property
    def has_refine_store(self) -> bool:
        """The regional store is the exact-refine row copy
        (``IndexConfig.refine_dtype``), not an R-MAC re-rank store. The
        config tells them apart: an ``rmac_levels=1`` re-rank store is
        ``[N, 1, D]`` too."""
        return bool(self.cfg.index.refine_dtype) and self.has_regional

    def _check_rescoring_cfg(self, scfg) -> None:
        """The reference's validation for every entry point (search,
        query_images, evaluate, which calls it before extracting): one
        re-scoring stage at a time, matching the attached store's kind, and
        one armed candidate tier (``ValueError``)."""
        enabled = [nm for nm in ("rerank_enabled", "diffusion_enabled",
                                 "refine_enabled", "lw_enabled")
                   if getattr(scfg, nm)]
        if len(enabled) > 1:
            raise ValueError(
                f"{' and '.join(enabled)} are mutually exclusive (one "
                f"re-scoring stage per query); disable all but one")
        if scfg.rerank_enabled and self.has_refine_store:
            raise ValueError(
                "this index's regional store is the exact-refine row copy "
                "(refine_dtype); use refine_enabled, not rerank_enabled")
        has_regional = self.has_regional
        if scfg.refine_enabled and not self.has_refine_store:
            raise ValueError(
                "refine_enabled needs the exact-refine store "
                "(IndexConfig.refine_dtype='int8' at build); this index "
                "has " + ("no regional store" if not has_regional else
                          "an R-MAC re-rank store (use rerank_enabled)"))
        if scfg.lw_enabled and self.lw is None:
            raise ValueError(
                "lw_enabled needs a fitted local-whitening view; call "
                "Index.fit_local_whitening() (or load an index saved "
                "with one)")
        if scfg.spatial_weight and not scfg.rerank_enabled:
            raise ValueError(
                "spatial_weight fuses into the regional re-rank; enable "
                "rerank_enabled (spatial verification has no meaning "
                "without region matches)")
        if (scfg.spatial_weight and has_regional
                and self.regional_geom is None):
            raise ValueError(
                "spatial_weight needs the R-MAC grid geometry; this "
                "index's regional store carries none (attached without a "
                "matching extractor) — set index.regional_geom = "
                "extractor.regional_geometry()")
        armed_tiers = [nm for nm, on in (
            ("ivf_nprobe", scfg.ivf_nprobe > 0 and self.ivf is not None),
            ("pq_depth", scfg.pq_depth > 0 and self.pq is not None),
            ("ivfpq_nprobe",
             scfg.ivfpq_nprobe > 0 and self.ivfpq is not None)) if on]
        if len(armed_tiers) > 1:
            raise ValueError(
                f"{' and '.join(armed_tiers)} all armed — one candidate-"
                f"selection tier per query (disable the others)")
        if self.is_l2:
            wrong = enabled + armed_tiers + (["qe_enabled"]
                                             if scfg.qe_enabled else [])
            if wrong:
                raise ValueError(
                    f"metric='l2' indexes support exact search only — "
                    f"disable {wrong} (QE/re-rank/diffusion/lw and the ANN "
                    f"tiers are cosine-space stages; see "
                    f"IndexConfig.metric)")

    def _reject_l2(self, stage: str) -> None:
        """The reference's one refusal of the cosine-space stages on an l2
        index (``ValueError``)."""
        if self.is_l2:
            raise ValueError(
                f"{stage} is a cosine-space stage — metric='l2' indexes "
                f"support exact search/search_range/knn_graph only "
                f"(IndexConfig.metric)")

    @property
    def vote_matrix(self) -> "torch.Tensor | None":
        """The spatial stage's one-hot transform-bin assignment ``[R*R,
        bins]`` on the index's device, built once from the grid geometry
        (``search/spatial.py``)."""
        if self.regional_geom is None:
            return None
        r = self.regions_per_image
        if r is not None and len(self.regional_geom) != r:
            raise ValueError(
                f"regional_geom has {len(self.regional_geom)} regions but "
                f"the store has {r}: geometry must "
                f"come from the same R-MAC grid as the store")
        if self._vote_m is None:
            self._vote_m = torch.as_tensor(build_vote_matrix(
                self.regional_geom, self.regional_geom), device=self.device)
        return self._vote_m

    def name_of(self, dataset_id: int) -> "str | None":
        """Dataset-position id (the values search() returns) -> image name.
        Not a names-list position: ids skip images quarantined at build."""
        n = len(self.names)
        if getattr(self, "_name_by_id_len", -1) != n:
            ids_np = self.ids[:n].cpu().numpy()
            self._name_by_id = {int(i): nm for i, nm in zip(ids_np,
                                                            self.names)}
            self._name_by_id_len = n
        return self._name_by_id.get(int(dataset_id))

    def with_search(self, **changes) -> "Index":
        """The same store tensors, ids, names and extractor behind the
        index's own search config with ``changes`` applied; e.g.
        ``with_search(use_pallas=False)`` ranks through the scoring oracle,
        since the route is the index's config, not a search argument's. The
        PQ, IVF, IVF-PQ and local-whitening views and the regional store
        come along, so the twin scans the same codes and re-ranks against
        the same regions."""
        cfg = self.cfg.replace(search=self.cfg.search.replace(**changes))
        twin = Index(self.descriptors, self.ids, self.names, cfg,
                     self.extractor, scales=self.scales, dim=self.dim)
        twin.pq, twin.lw = self.pq, self.lw
        twin.ivf, twin.ivfpq = self.ivf, self.ivfpq
        twin.regional, twin.regional_scales = (self.regional,
                                               self.regional_scales)
        twin.regional_geom, twin._vote_m = self.regional_geom, self._vote_m
        twin.quarantined = self.quarantined
        twin._layout_gen = self._layout_gen
        if self.placed:     # the same shards behind the twin's own config
            twin.placement = self.placement
            twin.placement = twin.to_sharded()
        return twin

    # ------------------------------------------------------------------
    def make_subset(self, names: "Sequence[str] | None" = None,
                    ids: "Sequence[int] | None" = None,
                    mask=None) -> SubsetFilter:
        """A reusable :class:`~instsearch_torch.search.subset.SubsetFilter`
        over exactly one of image ``names``, dataset ``ids`` or a raw
        ``[N_pad]`` position ``mask``, its ``[1, N_pad]`` int8 mask on the
        index's device. ``remove()`` and an ``add`` past capacity make it
        stale: it is then refused, never misapplied."""
        m = build_position_mask(self, names=names, ids=ids, mask=mask)
        return SubsetFilter(
            mask=torch.from_numpy(m[None, :].astype(np.int8)).to(self.device),
            count=int(m.sum()), layout_gen=self._layout_gen,
            n_pad=self.n_pad,
            names=tuple(names) if names is not None else None)

    def _resolve_subset(self, subset) -> "SubsetFilter | None":
        """``subset=`` -> a current SubsetFilter, or None: a prebuilt filter,
        or a sequence of names (str) or dataset ids built here. A filter of
        another layout generation or padded size raises ``ValueError``."""
        if subset is None:
            return None
        if not isinstance(subset, SubsetFilter):
            seq = list(subset)
            if seq and isinstance(seq[0], str):
                subset = self.make_subset(names=seq)
            else:
                subset = self.make_subset(ids=seq)
        if (subset.layout_gen != self._layout_gen
                or subset.n_pad != self.n_pad):
            raise ValueError(
                "stale SubsetFilter: rows were removed (or the store was "
                "re-padded) after it was built, so its positions no longer "
                "match — rebuild it with make_subset()")
        return subset

    # ------------------------------------------------------------------
    @classmethod
    def from_descriptors(cls, descriptors, names: Sequence[str], cfg,
                         extractor: Optional[Extractor] = None,
                         original_ids: "np.ndarray | None" = None,
                         _augmented: bool = False, *,
                         device: "torch.device | str | None" = None
                         ) -> "Index":
        """Pad ``descriptors [N, D]`` (numpy or tensor) into the store; an
        l2 index first appends each row's ``||x||^2/2`` (unless
        ``_augmented``: the rows carry it already, the re-pad path).
        ``original_ids`` maps rows back to dataset positions (differs from
        arange when images were quarantined). ``device`` defaults to the
        extractor's device, else the tensor's own, else (numpy input) the
        CUDA card, raising without one. ``refine_dtype="int8"`` over an
        int4 store attaches the exact-refine store, a one-region int8 copy
        of the original rows (``attach_regional_store``)."""
        _check_index_cfg(cfg)
        if device is None:
            device = (extractor.device if extractor is not None else
                      descriptors.device if isinstance(descriptors,
                                                       torch.Tensor)
                      else resolve_device(None))
        x = torch.as_tensor(descriptors, device=device)
        if cfg.index.metric == "l2" and not _augmented:
            x = x.float()
            x = torch.cat([x, 0.5 * (x * x).sum(1, keepdim=True)], 1)
        n, d = x.shape
        tile = max(cfg.index.row_tile, 8) * max(cfg.index.num_shards, 1)
        # capacity pre-sizes the padded store (0 = size to the dataset)
        n_pad = max(_pad_rows(max(n, cfg.index.capacity), tile), tile)
        ids = torch.full((n_pad,), -1, dtype=torch.int32, device=device)
        ids[:n] = (torch.arange(n, dtype=torch.int32, device=device)
                   if original_ids is None else
                   torch.as_tensor(np.asarray(original_ids, np.int32),
                                   device=device))
        # an odd width gains one zero column under int4 (nibbles pack in
        # pairs), which the reference counts in its dim; every store gains
        # zero columns up to the kernels' multiple, which it does not.
        # Queries are padded to match (_match_query_dim).
        dim = d + (d % 2 if cfg.index.dtype == "int4" else 0)
        width = _pad_rows(d, _COLUMN_MULTIPLE[cfg.index.dtype])
        quantize = _QUANTIZE.get(cfg.index.dtype)
        if quantize is None:
            store = torch.zeros((n_pad, width),
                                dtype=_DTYPES[cfg.index.dtype], device=device)
            store[:n, :d] = x.to(store.dtype)
            return cls(store, ids, list(names), cfg, extractor, dim=dim)
        # quantize the f32 padded rows, as the reference
        padded = torch.zeros((n_pad, width), dtype=torch.float32,
                             device=device)
        padded[:n, :d] = x.to(torch.float32)
        qr = quantize(padded)
        idx = cls(qr.values, ids, list(names), cfg, extractor,
                  scales=qr.scales, dim=dim)
        if cfg.index.refine_dtype:
            attach_regional_store(idx, padded[:n, None, :dim])
        return idx

    @classmethod
    def build(cls, paths: Sequence[str], cfg, variables: dict | None = None,
              whitening_paths: Sequence[str] | None = None,
              whitening: "WhiteningParams | None" = None, seed: int = 0,
              mesh=None, *,
              device: "torch.device | str | None" = None) -> "Index":
        """Offline indexing: extract -> (fit whitening) -> store.
        ``whitening_paths`` defaults to the indexed set itself;
        ``whitening`` supplies pre-fit params instead. With
        ``rerank_enabled`` one pass per image extracts the global
        descriptor and the regional rows (``extract_paths_with_regional``),
        which are whitened with the fit on the global descriptors and
        attached as the re-rank store. With ``cfg.index.dba_n`` the store is
        augmented (:meth:`augment_database`) at the end. Runs on
        ``device``, the CUDA card by default. ``mesh`` extracts
        data-parallel over its batch axis (``Extractor(mesh=)``; the store
        then lies on the axis's first device); without ``mesh`` and
        ``device`` it is ``default_data_mesh()``, every visible card when
        there are more than one, else None."""
        if cfg.index.metric == "l2":
            raise ValueError(
                "metric='l2' is for RAW-VECTOR indexes "
                "(Index.from_descriptors); the image pipeline's "
                "descriptors are unit-normalized, where inner product IS "
                "the L2 ranking — keep metric='ip'")
        _check_index_cfg(cfg)
        if mesh is None and device is None:
            from .parallel.mesh import default_data_mesh
            mesh = default_data_mesh()
        ex = Extractor(cfg.extract.replace(whiten=False), variables,
                       seed=seed, device=device, mesh=mesh)
        quarantine: list[str] = []
        regional = None
        if cfg.search.rerank_enabled:
            descs, regional, kept = ex.extract_paths_with_regional(
                paths, quarantine)
        else:
            descs, kept = ex.extract_paths(paths, quarantine)
        names = [os.path.splitext(os.path.basename(paths[i]))[0]
                 for i in kept]
        descs = torch.as_tensor(descs, device=ex.device)
        if cfg.extract.whiten or whitening is not None:
            if whitening is not None:
                ex.whitening = whitening
            else:
                wdescs = (descs if whitening_paths is None else
                          torch.as_tensor(ex.extract_paths(whitening_paths)[0],
                                          device=ex.device))
                ex.whitening = fit_whitening(
                    wdescs, dim=cfg.extract.whiten_dim or None)
            descs = apply_whitening(descs, ex.whitening)
            if regional is not None and len(regional):
                # the store was extracted before the fit existed
                regional = apply_whitening_regional(regional, ex.whitening)
        idx = cls.from_descriptors(descs, names, cfg, extractor=ex,
                                   original_ids=kept)
        idx.quarantined = quarantine
        if regional is not None:
            attach_regional_store(idx, regional)
        if cfg.index.dba_n:
            idx.augment_database()
        return idx

    def build_pq(self, m: int | None = None, iters: int = 15, seed: int = 0,
                 sample: "int | None" = 262_144, depth: int = 100,
                 chunk: int = 65_536, opq_iters: int = 0,
                 anisotropic_t: "float | None" = None) -> PQView:
        """Attach a product-quantization cascade view (search/pq_view.py):
        4-bit codes (ops/pq.py, 32 bytes per 512-d row) scanned by the
        fused ADC kernel select ``depth`` candidates, exactly re-scored
        against the main store. Arms ``cfg.search.pq_depth = depth``, so
        ``search()`` (with QE) routes through it; ``search_cfg.replace(
        pq_depth=0)`` keeps the exact path. ``opq_iters > 0`` also learns
        an OPQ rotation, ``anisotropic_t`` the score-aware codes instead
        (``ops/pq.py::fit_apq``). The fit and the encode run on the index's
        device; a placed store's rows are read through its placement, which
        stays (across processes the store is gathered first). Returns the
        PQView."""
        self._fit_prologue()
        self._reject_l2("build_pq")
        if self.ivfpq is not None:
            raise ValueError(
                "an IVF-PQ view is attached — mutually exclusive "
                "candidate-selection tiers (one per index)")
        if self.num_valid < 16_000_000:
            logging.getLogger("instsearch.index").warning(
                "build_pq at %d rows: the PQ tier is for capacity (32 bytes "
                "per 512-d row); below ~16M rows the exact int4/int8/bf16 "
                "stores usually fit the card, and they rank exactly without "
                "a candidate depth", self.num_valid)
        self.pq = PQView.from_index(self, m=m, iters=iters, seed=seed,
                                    sample=sample, depth=depth, chunk=chunk,
                                    opq_iters=opq_iters,
                                    anisotropic_t=anisotropic_t)
        self.cfg = self.cfg.replace(
            search=self.cfg.search.replace(pq_depth=depth))
        return self.pq

    def build_ivf(self, n_clusters: int | None = None, nprobe: int = 32,
                  iters: int = 10, seed: int = 0, cap_factor: float = 4.0,
                  sample: "int | None" = 262_144) -> IVFIndex:
        """Attach an IVF ANN view (``search/ivf.py``): a k-means coarse
        quantizer and a cluster-pruned scan, reading ~nprobe/n_clusters of
        the rows a query. Arms ``cfg.search.ivf_nprobe = nprobe``, so
        ``search()`` (αQE and the regional re-rank too) routes through it;
        ``search_cfg.replace(ivf_nprobe=0)`` keeps the exact path.
        Approximate: measure with ``ivf.measure_recall``. ``add()`` and
        ``remove()`` are absorbed, ``augment_database()`` drops the view.
        Fitted on the index's device; a placed store's rows are read through
        its placement, which stays (across processes the store is gathered
        first). Returns the IVFIndex."""
        self._fit_prologue()
        self._reject_l2("build_ivf")
        if self.is_int4:
            raise ValueError(
                "IVF views are not supported on int4 storage (the bucket "
                "gather re-materializes rows; use int8 for IVF, or int4 "
                "with the exact fused scan — it reads a quarter of bf16's "
                "bytes, which is the same latency class IVF targets)")
        if self.ivfpq is not None:
            raise ValueError(
                "an IVF-PQ view is attached — mutually exclusive "
                "candidate-selection tiers (one per index)")
        self.ivf = IVFIndex.from_index(self, n_clusters=n_clusters,
                                       nprobe=nprobe, iters=iters, seed=seed,
                                       cap_factor=cap_factor, sample=sample)
        self.cfg = self.cfg.replace(
            search=self.cfg.search.replace(ivf_nprobe=nprobe))
        return self.ivf

    def build_ivfpq(self, n_clusters: int | None = None, nprobe: int = 32,
                    m: int | None = None, kmeans_iters: int = 10,
                    pq_iters: int = 15, seed: int = 0,
                    cap_factor: float = 4.0,
                    sample: "int | None" = 262_144, depth: int = 400,
                    chunk: int = 65_536, opq_iters: int = 0,
                    anisotropic_t: "float | None" = None) -> IVFPQView:
        """Attach an IVF-PQ cascade view (``search/ivfpq.py``): k-means
        buckets of 4-bit RESIDUAL PQ codes, the ADC pruned to
        ``nprobe/n_clusters`` of the rows, then an exact re-score of
        ``depth`` candidates against the store. Arms
        ``cfg.search.ivfpq_nprobe``, so ``search()`` (αQE and the regional
        re-rank too) routes through it; ``search_cfg.replace(
        ivfpq_nprobe=0)`` keeps the exact path. Mutually exclusive with the
        IVF and PQ views. ``opq_iters > 0`` learns an OPQ rotation in
        residual space, ``anisotropic_t`` score-aware residual codes.
        ``add()`` and ``remove()`` are absorbed, ``augment_database()``
        drops the view. Fitted on the index's device; a placed store's rows
        are read through its placement, which stays (across processes the
        store is gathered first). Returns the IVFPQView."""
        self._fit_prologue()
        self._reject_l2("build_ivfpq")
        if self.ivf is not None or self.pq is not None:
            raise ValueError(
                "IVF-PQ is mutually exclusive with the IVF and PQ views "
                "(one candidate-selection tier per index); drop the "
                "other view first")
        self.ivfpq = IVFPQView.from_index(
            self, n_clusters=n_clusters, nprobe=nprobe, m=m,
            kmeans_iters=kmeans_iters, pq_iters=pq_iters, seed=seed,
            cap_factor=cap_factor, sample=sample, depth=depth, chunk=chunk,
            opq_iters=opq_iters, anisotropic_t=anisotropic_t)
        self.cfg = self.cfg.replace(
            search=self.cfg.search.replace(ivfpq_nprobe=self.ivfpq.nprobe))
        if self.placed:         # the placement carries the view's slices
            self._replace_placement()
        return self.ivfpq

    def _drop_views(self, why: str) -> None:
        """Drop the IVF, PQ, IVF-PQ and local-whitening views (their
        buckets, codes and whitened rows no longer match the store), with
        the reference's warnings; ``lw_enabled`` goes off with the view."""
        log = logging.getLogger("instsearch.index")
        if self.ivf is not None:
            log.warning("IVF view invalidated by %s; rebuild with "
                        "build_ivf()", why)
            self.ivf = None
        if self.pq is not None:
            log.warning("PQ view invalidated by %s; rebuild with "
                        "build_pq()", why)
            self.pq = None
        if self.ivfpq is not None:
            log.warning("IVF-PQ view invalidated by %s; rebuild with "
                        "build_ivfpq()", why)
            self.ivfpq = None
        if self.lw is not None:
            log.warning("local-whitening view invalidated by %s; refit "
                        "with fit_local_whitening()", why)
            self.lw = None
            self.cfg = self.cfg.replace(
                search=self.cfg.search.replace(lw_enabled=False))

    def fit_local_whitening(self, n_clusters: "int | None" = None,
                            dim: "int | None" = None, tau: float = 64.0,
                            iters: int = 10, seed: int = 0
                            ) -> LocalWhiteningView:
        """Attach a local-whitening re-ranking view
        (``search/lw_rerank.py``): a k-means-routed bank of per-cluster
        whitening transforms and the whitened row store, fitted on the
        index's device. Arms ``cfg.search.lw_enabled``: the
        top-``rerank_depth`` candidates are then re-scored under each
        candidate's own cluster metric. ``add`` and ``remove`` are absorbed;
        ``augment_database`` drops the view. A placed store's rows are read
        through its placement, which stays (across processes the store is
        gathered first). Returns the view."""
        self._fit_prologue()
        self._reject_l2("fit_local_whitening")
        self.lw = LocalWhiteningView.from_index(
            self, n_clusters=n_clusters, dim=dim, tau=tau, iters=iters,
            seed=seed)
        self.cfg = self.cfg.replace(
            search=self.cfg.search.replace(lw_enabled=True))
        if self.placed:         # the placement carries the whitened rows
            self._replace_placement()
        return self.lw

    def _query_rows(self, start: int, chunk: int) -> torch.Tensor:
        """Stored rows ``[start, start + chunk)`` as f32 queries of the
        store's width (the zero columns back), for the self-searches."""
        return torch.nn.functional.pad(
            self._rows_f32_chunk(start, chunk), (0, self.store_dim - self.dim))

    def augment_database(self, n: "int | None" = None,
                         alpha: "float | None" = None,
                         chunk: "int | None" = None, mesh=None) -> None:
        """αDBA (``search/dba.py``): replace every stored row by the
        ``s^alpha``-weighted sum of its ``n`` nearest stored rows (itself
        included, weight 1). Each ``chunk`` of stored rows queries the
        ORIGINAL store through the serving top-k (K1-K3 on the card; the
        start slides back to ``N_pad - chunk`` near the end), the results go
        into an f32 buffer, and the buffer replaces the store once at the
        end: an int8/int4 store is quantized once from it, an int8 refine
        copy derived from the same buffer; an R-MAC regional store keeps its
        raw rows. The IVF, PQ, IVF-PQ and local-whitening views are dropped
        (the rows changed). ``n``/``alpha`` default to ``cfg.index.dba_n``
        (10 when 0) and ``dba_alpha``. ``mesh`` selects the neighbours through
        ``to_sharded(mesh)`` (``expand_queries(include_query=False)``), with
        the same result. Rows added later are not augmented. A placed store
        (``load(mesh=)``) is gathered first: the reference's augmented store
        comes back replicated, not sharded."""
        self.gather()
        self._reject_l2("augment_database")
        n = n if n is not None else (self.cfg.index.dba_n or 10)
        alpha = float(self.cfg.index.dba_alpha if alpha is None else alpha)
        if self.num_valid == 0:
            return
        n_pad = self.descriptors.shape[0]
        n = min(n, n_pad)
        chunk = min(chunk or self.cfg.search.query_chunk or 128, n_pad)
        use_kernel = bool(self.cfg.search.use_pallas)
        buf = torch.zeros((n_pad, self.store_dim), dtype=torch.float32,
                          device=self.device)
        sidx = self.to_sharded(mesh=mesh) if mesh is not None else None
        for start in range(0, self.num_valid, chunk):
            s0 = min(start, n_pad - chunk)
            rows_q = self._query_rows(s0, chunk)
            if sidx is not None:
                rows = sidx.expand_queries(rows_q, qe_n=n, alpha=alpha,
                                           include_query=False).to(self.device)
            else:
                rows = _expand(self.descriptors, self.ids, rows_q,
                               self.num_valid, self.scales, qe_n=n,
                               qe_alpha=alpha, use_kernel=use_kernel,
                               int4=self.is_int4, include_query=False)
            valid = (self.ids[s0:s0 + chunk] >= 0)[:, None]
            buf[s0:s0 + chunk] = torch.where(valid, rows,
                                             torch.zeros((), device=rows.device))
        del sidx
        self._drop_views("augment_database()")
        # the old store goes before the new one is made, and the new one is
        # made from the buffer in pieces: the peak is the buffer, the new
        # store and one piece's temporaries
        self.descriptors = None
        quantize = _QUANTIZE.get(self.cfg.index.dtype)
        if quantize is not None:
            self.descriptors, self.scales = self._quantize_pieces(buf,
                                                                  quantize)
        else:
            self.descriptors = buf.to(_DTYPES[self.cfg.index.dtype])
        if self.has_refine_store:
            qr = self._quantize_pieces(buf[:, :self.dim], quantize_rows)
            self.regional = qr[0][:, None, :]
            self.regional_scales = qr[1].reshape(-1, 1)
        COUNTERS.add("rows_dba_augmented", self.num_valid)

    @staticmethod
    def _quantize_pieces(rows: torch.Tensor, quantize,
                         piece: int = 1 << 16):
        """``quantize(rows)`` as ``(values, scales [1, N])``, made
        ``piece`` rows at a time (the quantizers are row-wise)."""
        n = rows.shape[0]
        first = quantize(rows[:min(piece, n)])
        values = first.values.new_empty((n,) + tuple(first.values.shape[1:]))
        scales = first.scales.new_empty((1, n))
        for i in range(0, n, piece):
            qr = first if i == 0 else quantize(rows[i:i + piece])
            values[i:i + piece] = qr.values
            scales[:, i:i + piece] = qr.scales.reshape(1, -1)
        return values, scales

    def knn_graph(self, k: int = 10, chunk: "int | None" = None,
                  subset=None, mesh=None):
        """Every indexed row's ``k`` nearest other rows -> ``(scores
        [num_valid, k] f32, dataset ids [num_valid, k] int32)`` numpy, row
        ``p`` for ``names[p]``, best first. Each ``chunk`` of stored rows
        queries the store through the serving top-k for ``k + 1`` (K1-K3 on
        the card) and the row itself is struck by position, so even
        identical rows stay each other's neighbours. ``subset`` restricts
        the neighbour side; rows with fewer than ``k`` neighbours pad with
        ``(-inf, -1)``. ``mesh`` selects through ``to_sharded(mesh)``,
        striking the row by its dataset id (unique), with the same result
        (a placed index selects through its own placement). An l2 index
        gives ``-||x - y||^2``: each stored row's norm column becomes the
        query's ``-1`` column."""
        nv = self.num_valid
        out_s = np.full((nv, k), -np.inf, np.float32)
        out_i = np.full((nv, k), -1, np.int32)
        if nv == 0:
            return out_s, out_i
        n_pad = self.n_pad
        k = min(k, max(1, n_pad - 1))
        chunk = min(chunk or self.cfg.search.query_chunk or 128, n_pad)
        subset = self._resolve_subset(subset)
        mask = subset.mask if subset is not None else None
        sidx = (self.to_sharded(mesh=mesh) if mesh is not None else
                self.placement)
        smask = (sidx.place_subset(subset)
                 if sidx is not None and subset is not None else None)
        ids_np = self.ids.cpu().numpy()
        for start in range(0, nv, chunk):
            s0 = min(start, n_pad - chunk)      # slide back near the end
            off = start - s0
            rows_q = self._query_rows(s0, chunk)
            qnorm2 = None
            if self.is_l2:                   # swap norm col -> query col
                qnorm2 = 2.0 * rows_q[:, self.dim - 1].cpu().numpy()
                rows_q[:, self.dim - 1] = -1.0
            if sidx is not None:
                s, i = (t.cpu().numpy() for t in
                        sidx.search(rows_q, k=k + 1, mask=smask))
                own = ids_np[s0:s0 + chunk, None]
                s = np.where(i == own, -np.inf, s)
                i = np.where(i == own, -1, i)
                order = np.argsort(-s, axis=1, kind="stable")[:, :k]
                s = np.take_along_axis(s, order, axis=1)
                i = np.take_along_axis(i, order, axis=1)
                s = np.where(own >= 0, s, -np.inf)
                i = np.where((own >= 0) & (s > -np.inf), i, -1)
            else:
                s, pos = _topk_raw(self.descriptors, self.ids, rows_q, nv,
                                   self.scales, k=k + 1,
                                   use_kernel=bool(self.cfg.search.use_pallas),
                                   int4=self.is_int4, mask=mask)
                own = s0 + torch.arange(chunk, device=pos.device)
                s = s.masked_fill(pos == own[:, None], float("-inf"))
                s, sel = select_topk(s, k)   # the struck slot falls off
                pos = torch.take_along_dim(pos, sel.clamp(min=0).long(), 1)
                s = s.masked_fill((self.ids[s0:s0 + chunk] < 0)[:, None],
                                  float("-inf"))
                s, i = s.cpu().numpy(), _pos_to_ids(self.ids, s,
                                                    pos).cpu().numpy()
            if qnorm2 is not None:
                s = _l2_scores(s, i, qnorm2)
            take = min(chunk - off, nv - start)
            out_s[start:start + take] = s[off:off + take]
            out_i[start:start + take] = i[off:off + take]
        return out_s, out_i

    def find_duplicates(self, tau: float = 0.97, k: int = 16,
                        chunk: "int | None" = None, subset=None,
                        group: bool = False, mesh=None):
        """Near-duplicates from :meth:`knn_graph`: ``(pairs [P, 2] int32
        dataset ids, scores [P] f32)``, each unordered pair once (``id_a <
        id_b``) at its best score ``>= tau``, best first; with ``group=True``
        the connected components of those pairs (a union-find) as lists of
        names, largest first, so a chain a~b~c is one group even where a.c
        < tau. Each row gives at most its ``k`` nearest as edges. On an l2
        index ``tau`` is a Euclidean radius (pair scores ``-||a - b||^2``)."""
        s, i = self.knn_graph(k=k, chunk=chunk, subset=subset, mesh=mesh)
        tau = -(float(tau) ** 2) if self.is_l2 else tau
        row_ids = self.ids[:self.num_valid].cpu().numpy()
        qa = np.repeat(row_ids, k).reshape(-1)
        qb = i.reshape(-1)
        sc = s.reshape(-1)
        keep = (qb >= 0) & (sc >= tau) & (qa != qb)
        qa, qb, sc = qa[keep], qb[keep], sc[keep]
        lo, hi = np.minimum(qa, qb), np.maximum(qa, qb)
        order = np.lexsort((-sc, hi, lo))    # each pair's best score first
        lo, hi, sc = lo[order], hi[order], sc[order]
        first = np.ones(len(lo), bool)
        first[1:] = (lo[1:] != lo[:-1]) | (hi[1:] != hi[:-1])
        lo, hi, sc = lo[first], hi[first], sc[first]
        best = np.argsort(-sc, kind="stable")
        pairs = np.stack([lo[best], hi[best]], axis=1).astype(np.int32)
        sc = sc[best].astype(np.float32)
        if not group:
            return pairs, sc
        parent: dict = {}

        def find(x):
            r = x
            while parent.get(r, r) != r:
                r = parent[r]
            while parent.get(x, x) != x:     # path compression
                parent[x], x = r, parent[x]
            return r

        for a, b in pairs:
            ra, rb = find(int(a)), find(int(b))
            if ra != rb:
                parent[ra] = rb
        comps: dict = {}
        for a in set(pairs.reshape(-1).tolist()):
            comps.setdefault(find(a), []).append(a)
        groups = sorted(comps.values(), key=len, reverse=True)
        return [[self.name_of(a) for a in sorted(g)] for g in groups]

    def stats(self) -> dict:
        """What the index holds, from tensor metadata alone: rows, capacity,
        dim (the caller's width), metric, dtype, layout generation, the
        bytes of each store on the devices (the store's zero columns
        included) and the attached views' parameters."""
        def nbytes(t):
            return 0 if t is None else int(t.numel() * t.element_size())

        def store_bytes(name):
            if not self.placed:
                return nbytes(getattr(self, name))
            return sum(nbytes(t) for t in self._parts(name) or ())

        out = {
            "rows": self.num_valid,
            "capacity": self.n_pad,
            "dim": self.user_dim,
            "metric": self.cfg.index.metric,
            "dtype": self.cfg.index.dtype,
            "layout_gen": self._layout_gen,
            "has_extractor": self.extractor is not None,
            "bytes": {
                "descriptors": store_bytes("descriptors"),
                "scales": store_bytes("scales"),
                "regional": store_bytes("regional")
                + store_bytes("regional_scales"),
            },
        }
        if self.has_regional:
            out["regional_kind"] = ("refine" if self.has_refine_store
                                    else "rmac")
            out["regions_per_image"] = self.regions_per_image
        if self.ivf is not None:
            v = self.ivf
            out["ivf"] = {
                "n_clusters": v.n_clusters, "nprobe": v.nprobe,
                "bucket_capacity": v.bucket_capacity,
                "spill_rows": int(v.spill.shape[0]),
                "scan_fraction": round(v.scan_fraction(), 4),
            }
            out["bytes"]["ivf"] = (nbytes(v.centroids) + nbytes(v.buckets)
                                   + nbytes(v.spill))
        if self.pq is not None:
            v = self.pq
            out["pq"] = {"m": v.m, "depth": v.depth,
                         "bytes_per_row": v.m // 2,
                         "opq": v.rotation is not None,
                         "anisotropic_t": v.anisotropic_t}
            out["bytes"]["pq"] = nbytes(v.packed)
        if self.ivfpq is not None:
            v = self.ivfpq
            out["ivfpq"] = {
                "n_clusters": v.n_clusters, "nprobe": v.nprobe,
                "m": v.m, "depth": v.depth,
                "bucket_capacity": v.bucket_capacity,
                "spill_rows": int(v.spill_codes.shape[0]),
                "scan_fraction": round(v.scan_fraction(), 4),
                "opq": v.rotation is not None,
                "anisotropic_t": v.anisotropic_t,
            }
            out["bytes"]["ivfpq"] = (nbytes(v.centroids) + nbytes(v.codes)
                                     + nbytes(v.spill_codes))
        if self.lw is not None:
            out["lw"] = {"n_clusters": self.lw.n_clusters}
            out["bytes"]["lw"] = (nbytes(self.lw.store)
                                  + nbytes(self.lw.params.P))
        out["bytes"]["total"] = sum(out["bytes"].values())
        return out

    def _rows_f32_chunk(self, start: int, chunk: int) -> torch.Tensor:
        """Stored rows ``[start, start + chunk)`` as f32 ``[chunk, dim]``,
        unpacked (int4) and dequantized (int8, int4), without the kernels'
        zero columns. The callers cut the store into slices that divide it,
        so no slice runs past its end (the reference's dynamic_slice would
        move such a slice back). A placed store's rows come from its
        shards, on the first device."""
        if self.placed:
            pos = torch.arange(start, min(start + chunk, self.n_pad),
                               device=self.device)
            return self.placement.rows_f32(pos)[:, :self.dim]
        rows = self.descriptors[start:start + chunk]
        if self.is_int4:
            rows = unpack_int4(rows)
        rows = rows[:, :self.dim].float()
        if self.scales is not None:
            rows = rows * self.scales[0, start:start + chunk, None]
        return rows

    # ------------------------------------------------------------------
    def _match_query_dim(self, q: torch.Tensor) -> torch.Tensor:
        """Queries of the descriptor width (or, for an int4 store of an odd
        width, one narrower, as the reference takes them) gain the store's
        zero columns, which never change a dot product. An l2 index's
        queries of the caller's width gain the ``-1`` column first, so
        ``x'.q' = x.q - ||x||^2/2`` ranks as ``-||x - q||``."""
        w = q.shape[-1]
        if self.is_l2 and w == self.dim - 1:
            q = torch.cat([q.float(), q.new_full(q.shape[:-1] + (1,), -1.0,
                                                 dtype=torch.float32)], -1)
            w += 1
        if w == self.dim or (self.is_int4 and w == self.dim - 1):
            q = torch.nn.functional.pad(q, (0, self.store_dim - w))
        return q

    def _l2_query_norms(self, q: torch.Tensor) -> "np.ndarray | None":
        """``||q||^2 [Q]`` f32 of an l2 index's queries (of the caller's
        width, or with the ``-1`` column, which is dropped) for the score
        conversion, or None on an ip index."""
        if not self.is_l2:
            return None
        qn = q[..., :self.dim - 1].float()
        return (qn * qn).sum(-1).cpu().numpy()

    def search(self, queries, search_cfg=None, query_regional=None,
               subset=None):
        """Descriptor-space search: ``queries [Q, D]`` (or ``[D]``) ->
        ``(scores [Q, k], ids [Q, k])`` numpy arrays, with alpha-QE when
        ``search_cfg.qe_enabled``, the regional re-rank when
        ``rerank_enabled`` and a store and ``query_regional [Q, Rq, D]`` are
        there (``query_images`` extracts them), the exact refine when
        ``refine_enabled``, diffusion when ``diffusion_enabled``, the
        local-whitening re-score when ``lw_enabled``. The candidate tiers,
        in the reference's order: the IVF scan when that view is attached
        and ``ivf_nprobe > 0``, the PQ cascade (``pq_depth > 0``), the
        IVF-PQ cascade (``ivfpq_nprobe > 0``); without its view a tier's
        setting is ignored, as in the reference. Diffusion and local
        whitening keep the exact scan, and so does refine under the
        cascades (their exact re-score is one). The kernel or oracle route
        is the index's own ``cfg.search.use_pallas``, not the argument's,
        as in the reference. Batches larger than ``query_chunk`` run the whole
        composite in pieces (utils/chunking.py): the re-rank stage gathers
        ``[chunk, depth, R, D]`` candidate regions. ``subset`` (a
        :meth:`make_subset` filter, or names or ids built here) restricts
        every top-k to its members. An l2 index takes exact search only and
        returns ``-||x - q||^2``. A placed store (``load(mesh=)``) stays
        placed: it answers through its sharded view, the same answers, and
        a candidate tier (IVF, PQ, IVF-PQ) armed on it reads only its
        candidates' rows from the shards (across processes, collectively:
        every process searches the same queries)."""
        scfg = search_cfg or self.cfg.search
        self._check_rescoring_cfg(scfg)
        q = torch.as_tensor(queries, device=self.device)
        if q.ndim == 1:
            q = q[None]
        w = q.shape[-1]
        qn2 = self._l2_query_norms(q)
        q = self._match_query_dim(q.float())
        if q.shape[-1] != self.store_dim:
            raise ValueError(f"queries have width {w}, the store {self.dim}")
        do_refine = scfg.refine_enabled
        do_diffusion = scfg.diffusion_enabled
        do_lw = scfg.lw_enabled and self.lw is not None
        # diffusion needs the exact top-depth neighbourhood and lw re-scores a
        # quality-critical candidate set: both keep the exact scan; refine is
        # redundant under a cascade (its exact re-score is one)
        if (self.ivf is not None and scfg.ivf_nprobe > 0
                and not (do_diffusion or do_lw)):
            tier = self._search_ivf
        elif (self.pq is not None and scfg.pq_depth > 0
                and not (do_refine or do_diffusion or do_lw)):
            tier = self._search_pq
        elif (self.ivfpq is not None and scfg.ivfpq_nprobe > 0
                and not (do_refine or do_diffusion or do_lw)):
            tier = self._search_ivfpq
        else:
            tier = None
        if self.placed and tier is None:
            COUNTERS.add("queries_served", q.shape[0])
            s, i = self.search_sharded(self.placement, q, scfg,
                                       query_regional, subset)
            return (s, i) if qn2 is None else (_l2_scores(s, i, qn2), i)
        subset = self._resolve_subset(subset)
        mask = subset.mask if subset is not None else None
        COUNTERS.add("queries_served", q.shape[0])
        do_rerank = (scfg.rerank_enabled and self.has_regional
                     and query_regional is not None)
        args = (q,)
        if do_rerank:
            qreg = torch.as_tensor(query_regional,
                                   device=self.device).float()
            reg_d = (self._parts("regional")[0] if self.placed
                     else self.regional).shape[2]
            if (qreg.ndim != 3 or qreg.shape[0] != q.shape[0]
                    or qreg.shape[2] != reg_d):
                raise ValueError(
                    f"query_regional {tuple(qreg.shape)}: [Q, Rq, "
                    f"{reg_d}] for {q.shape[0]} queries")
            args = (q, qreg)
        depth = min(scfg.diffusion_depth if do_diffusion else
                    scfg.rerank_depth, self.n_pad)
        sw = float(scfg.spatial_weight) if do_rerank else 0.0

        def run(qq, *qreg):
            return _search_composite(
                self.descriptors, self.ids, qq, self.num_valid, self.scales,
                self.regional, self.regional_scales,
                qreg[0] if qreg else None, self.vote_matrix if sw else None,
                k=scfg.k, qe_n=scfg.qe_n, qe_alpha=scfg.qe_alpha,
                use_kernel=bool(self.cfg.search.use_pallas),
                do_qe=scfg.qe_enabled, int4=self.is_int4, depth=depth,
                do_rerank=do_rerank, do_refine=do_refine, spatial_weight=sw,
                mask=mask, do_diffusion=do_diffusion,
                diff_knn=scfg.diffusion_knn, diff_alpha=scfg.diffusion_alpha,
                diff_iters=scfg.diffusion_iters,
                diff_seeds=scfg.diffusion_seeds)

        if tier is not None:
            s, i = tier(args, scfg, do_rerank, mask)
        elif do_lw:
            s, i = self._search_lw(q, scfg, mask)
        else:
            s, i = run_chunked(run, scfg.query_chunk, *args)
        s, i = s.cpu().numpy(), i.cpu().numpy()
        return (s, i) if qn2 is None else (_l2_scores(s, i, qn2), i)

    def _search_lw(self, q: torch.Tensor, scfg, mask=None):
        """The local-whitening composite (``_lw_composite``) in pieces that
        keep the ``[chunk, E, dim]`` all-expert query block and the
        candidate gather under 256 MiB, as the reference."""
        lw = self.lw
        depth = min(scfg.rerank_depth, self.descriptors.shape[0])

        def run(qq):
            return _lw_composite(
                self.descriptors, self.ids, qq, self.num_valid, self.scales,
                lw, mask, k=scfg.k, depth=depth, qe_n=scfg.qe_n,
                qe_alpha=scfg.qe_alpha,
                use_kernel=bool(self.cfg.search.use_pallas),
                do_qe=scfg.qe_enabled, int4=self.is_int4)

        per_q = max(1, lw.n_clusters * lw.dim * 4 + depth * lw.dim * 8)
        chunk = max(1, min(scfg.query_chunk or q.shape[0],
                           (256 << 20) // per_q))
        return run_chunked(run, chunk, q)

    def _rerank_operands(self, do_rerank: bool, scfg) -> dict:
        """The re-rank stage's operands of a candidate tier's composite:
        the regional store's reader (``_regions_at``), the vote matrix and
        the spatial weight when ``do_rerank``, else none of them."""
        sw = float(scfg.spatial_weight) if do_rerank else 0.0
        return {"regional": self._regions_at if do_rerank else None,
                "vote_matrix": self.vote_matrix if sw else None,
                "spatial_weight": sw}

    def _search_pq(self, args, scfg, do_rerank: bool, mask=None):
        """The PQ cascade (search/pq_view.py): the ADC scan over the codes
        selects ``depth`` candidates (at least k, qe_n with QE and
        rerank_depth with the re-rank), exactly re-scored against the store;
        QE and the regional re-rank compose by position; a subset ``mask``
        applies at the ADC selection. ``args``: the queries, and their
        regions with the re-rank. Chunked so the per-stage ``[chunk, depth,
        D]`` f32 gather stays under 256 MiB."""
        pq = self.pq
        depth = max(scfg.pq_depth, scfg.k,
                    scfg.qe_n if scfg.qe_enabled else 0,
                    scfg.rerank_depth if do_rerank else 0)
        depth = min(depth, self.n_pad)
        rr = self._rerank_operands(do_rerank, scfg)

        def run(qq, *qreg):
            return _pq_composite(
                pq.packed, pq.codebook.centroids, self._rows_f32_at, self.ids,
                qq, self.num_valid, pq.rotation, mask, rr["regional"],
                qreg[0] if do_rerank else None, rr["vote_matrix"], k=scfg.k,
                depth=depth, qe_n=scfg.qe_n, qe_alpha=scfg.qe_alpha,
                do_qe=scfg.qe_enabled,
                use_kernel=bool(self.cfg.search.use_pallas),
                do_rerank=do_rerank, spatial_weight=rr["spatial_weight"],
                rerank_depth=min(scfg.rerank_depth, depth))

        per_q = max(1, 2 * depth * self.dim * 4)
        chunk = max(1, min(scfg.query_chunk or args[0].shape[0],
                           (256 << 20) // per_q))
        return run_chunked(run, chunk, *args)

    def _search_ivf(self, args, scfg, do_rerank: bool, mask=None):
        """The IVF scan (search/ivf.py) as every candidate selection of the
        composite (αQE, re-rank, top-k). Chunked so the per-query
        ``[chunk, nprobe, M, D]`` bucket gather stays under 256 MiB."""
        ivf = self.ivf
        nprobe = min(scfg.ivf_nprobe, ivf.n_clusters)
        depth = min(scfg.rerank_depth, self.n_pad) if do_rerank else 0
        rr = self._rerank_operands(do_rerank, scfg)

        def run(qq, *qreg):
            return _ivf_composite(
                ivf.arrays, self._rows_f32_at, self.ids, rr["regional"],
                qreg[0] if do_rerank else None, qq, rr["vote_matrix"], mask,
                k=scfg.k, depth=depth, qe_n=scfg.qe_n,
                qe_alpha=scfg.qe_alpha, nprobe=nprobe, do_qe=scfg.qe_enabled,
                do_rerank=do_rerank, spatial_weight=rr["spatial_weight"])

        row_bytes = ivf.buckets.shape[2] * ivf.buckets.element_size()
        per_q = max(1, nprobe * ivf.bucket_capacity * row_bytes)
        chunk = max(1, min(scfg.query_chunk or args[0].shape[0],
                           (256 << 20) // per_q))
        return run_chunked(run, chunk, *args)

    def _search_ivfpq(self, args, scfg, do_rerank: bool, mask=None):
        """The IVF-PQ cascade (search/ivfpq.py) as every candidate selection
        of the composite: the pruned residual ADC selects ``depth``
        candidates (at least the view's depth, k, qe_n with QE and
        rerank_depth with the re-rank), exactly re-scored against the store.
        Chunked so the ``[chunk, nprobe, M, m/2]`` code gather and the
        ``[chunk, depth, D]`` re-score gather stay under 256 MiB."""
        v = self.ivfpq
        nprobe = min(scfg.ivfpq_nprobe, v.n_clusters)
        depth = max(v.depth, scfg.k, scfg.qe_n if scfg.qe_enabled else 0,
                    scfg.rerank_depth if do_rerank else 0)
        depth = min(depth, self.n_pad)
        rr = self._rerank_operands(do_rerank, scfg)

        def run(qq, *qreg):
            return _ivfpq_composite(
                v.arrays, self._rows_f32_at, self.ids, rr["regional"],
                qreg[0] if do_rerank else None, qq, rr["vote_matrix"], mask,
                k=scfg.k, depth=depth, qe_n=scfg.qe_n,
                qe_alpha=scfg.qe_alpha, nprobe=nprobe, do_qe=scfg.qe_enabled,
                do_rerank=do_rerank, spatial_weight=rr["spatial_weight"],
                rerank_depth=min(scfg.rerank_depth, depth))

        per_q = max(1, nprobe * v.bucket_capacity * v.bytes_per_row
                    + 2 * depth * self.dim * 4)
        chunk = max(1, min(scfg.query_chunk or args[0].shape[0],
                           (256 << 20) // per_q))
        return run_chunked(run, chunk, *args)

    def query(self, queries, search_cfg=None, k: Optional[int] = None, **kw):
        """``index.query(x, k=10)``: descriptor arrays ([Q, D] / [D]) or
        uint8 image batches ([Q, S, S, 3] / [S, S, 3])."""
        q = queries if hasattr(queries, "ndim") else np.asarray(queries)
        scfg = search_cfg or self.cfg.search
        if k is not None:
            scfg = scfg.replace(k=k)
        is_image = q.ndim in (3, 4) and q.shape[-1] == 3
        is_uint8 = q.dtype in (np.uint8, torch.uint8)
        if is_image:
            if not is_uint8:
                lo, hi = float(q.min()), float(q.max())
                if lo < 0.0 or hi > 1.0:
                    raise ValueError(
                        f"float image batch has values in [{lo:g}, {hi:g}]; "
                        f"query() expects uint8 pixels [0, 255] or float "
                        f"images pre-scaled to [0, 1]")
            return self.query_images(q if q.ndim == 4 else q[None], scfg,
                                     **kw)
        if q.ndim in (1, 2) and not is_uint8:
            return self.search(q, scfg, **kw)
        raise ValueError(
            f"query() expects uint8/float image batches [Q,S,S,3]/[S,S,3] "
            f"or float descriptors [Q,D]/[D]; got shape {tuple(q.shape)} "
            f"dtype {q.dtype}")

    def query_images(self, images, search_cfg=None, sharded_index=None,
                     subset=None):
        """Image-space search: uint8 batch -> extract -> search. With
        re-ranking on and a regional store attached, the query's regional
        rows come from the same backbone pass as its global descriptor
        (``Extractor.extract_with_regional``): the values of the reference's
        two passes, for one. ``subset`` filters as in :meth:`search`; the
        sharded route cuts its mask per shard
        (``ShardedIndex.place_subset``)."""
        if self.extractor is None:
            raise ValueError("index has no extractor attached")
        scfg = search_cfg or self.cfg.search
        self._check_rescoring_cfg(scfg)
        qreg = None
        if scfg.rerank_enabled and self.has_regional:
            q, qreg = self.extractor.extract_with_regional(images)
        else:
            q = self.extractor(images)
        if sharded_index is None:
            return self.search(q, scfg, query_regional=qreg, subset=subset)
        COUNTERS.add("queries_served", q.shape[0])
        return self.search_sharded(sharded_index, q, scfg,
                                   query_regional=qreg, subset=subset)

    def search_sharded(self, sidx, queries, search_cfg=None,
                       query_regional=None, subset=None):
        """Descriptor-space search through ``sidx`` (``to_sharded()``), the
        reference's sharded route of ``query_images``: alpha-QE by
        ``expand_queries``, then the regional re-rank (with
        ``query_regional``), the exact refine (a one-region store, the query
        its own region, no global term), diffusion, the local-whitening
        re-score or the plain sharded top-k -> ``(scores [Q, k], ids [Q,
        k])`` numpy arrays. ``subset`` is cut into
        each shard's ``[1, C]`` slice of its mask. With ``ivfpq_nprobe > 0``
        and the IVF-PQ view attached to ``sidx`` (``to_sharded`` attaches
        it), the sharded IVF-PQ cascade answers, with αQE, as the reference
        gates it: not with diffusion, local whitening, refine or a regional
        re-rank, which keep the exact sharded selection. The PQ and IVF
        views are not used: their tiers are single-device, as in the
        reference."""
        scfg = search_cfg or self.cfg.search
        self._check_rescoring_cfg(scfg)
        subset = self._resolve_subset(subset)
        smask = sidx.place_subset(subset) if subset is not None else None
        q, qreg = queries, query_regional
        if (scfg.ivfpq_nprobe > 0 and sidx.ivfpq is not None
                and not (scfg.diffusion_enabled or scfg.lw_enabled
                         or scfg.refine_enabled)
                and not (scfg.rerank_enabled and sidx.regional is not None)):
            s, i = sidx.search_ivfpq(
                q, k=scfg.k, nprobe=scfg.ivfpq_nprobe,
                qe_n=scfg.qe_n if scfg.qe_enabled else 0,
                qe_alpha=scfg.qe_alpha, mask=smask)
            return s.cpu().numpy(), i.cpu().numpy()
        if scfg.qe_enabled:
            q = sidx.expand_queries(q, qe_n=scfg.qe_n, alpha=scfg.qe_alpha,
                                    mask=smask)
        if (scfg.rerank_enabled and sidx.regional is not None
                and qreg is not None):
            s, i = sidx.search_rerank(q, qreg, k=scfg.k,
                                      depth=scfg.rerank_depth,
                                      spatial_weight=scfg.spatial_weight,
                                      mask=smask)
        elif scfg.refine_enabled:
            s, i = sidx.search_refine(q, k=scfg.k, depth=scfg.rerank_depth,
                                      mask=smask)
        elif scfg.diffusion_enabled:
            s, i = sidx.search_diffusion(
                q, k=scfg.k, depth=scfg.diffusion_depth,
                knn=scfg.diffusion_knn, alpha=scfg.diffusion_alpha,
                iters=scfg.diffusion_iters, seeds=scfg.diffusion_seeds,
                mask=smask)
        elif scfg.lw_enabled:
            s, i = sidx.search_lw(q, k=scfg.k, depth=scfg.rerank_depth,
                                  mask=smask)
        else:
            s, i = sidx.search(q, k=scfg.k, mask=smask)
        return s.cpu().numpy(), i.cpu().numpy()

    # ------------------------------------------------------------------
    def search_range(self, queries, tau: float, max_results: int = 1024,
                     subset=None, mesh=None):
        """Range search: every row scoring ``>= tau`` -> ``(scores [Q, m],
        ids [Q, m], counts [Q])`` numpy arrays, ``m = min(max_results,
        N_pad)``. The members are the top-``m`` of the index's own route
        (the kernel of the store's kind, or the oracle) cut at ``tau``,
        score-sorted, the slots past them ``(-inf, -1)``; the counts are
        exhaustive, from a pass over the dequantized store
        (``range_count``: f32 rows, f64 products, bounded chunks of rows,
        no ``[Q, N_pad]`` matrix), so ``counts > max_results`` flags a
        cut list. A quantized
        store's member scores are the kernel's, its counts re-scores of
        the dequantized rows: a row within a quantization step of ``tau``
        may fall on the other side of it in one of the two. ``subset``
        filters both. On an l2 index ``tau`` is a Euclidean radius, turned
        into one threshold a query, ``(||q||^2 - tau^2)/2``, and the scores
        are ``-||x - q||^2``. ``mesh`` (or a placed store's own mesh)
        answers through ``ShardedIndex.search_range``: the members of the
        sharded merge, the counts summed over the shards; the same
        answers."""
        q = torch.as_tensor(queries, device=self.device).float()
        if q.ndim == 1:
            q = q[None]
        w = q.shape[-1]
        qn2 = self._l2_query_norms(q)
        q = self._match_query_dim(q)
        if q.shape[-1] != self.store_dim:
            raise ValueError(f"queries have width {w}, the store {self.dim}")
        subset = self._resolve_subset(subset)
        COUNTERS.add("queries_served", q.shape[0])
        # one f32 threshold a query: tau, or an l2 radius's (||q||² - tau²)/2
        thr = torch.as_tensor(
            np.full(q.shape[0], tau, np.float32) if qn2 is None else
            (qn2 - np.float32(float(tau) ** 2)) / np.float32(2.0),
            device=self.device)
        if mesh is not None or self.placed:
            sidx = (self.to_sharded(mesh=mesh) if mesh is not None
                    else self.placement)
            s, i, counts = sidx.search_range(
                q, thr, max_results=max_results,
                mask=sidx.place_subset(subset) if subset is not None
                else None)
        else:
            mask = subset.mask if subset is not None else None
            m = min(max_results, self.n_pad)

            def run(qq):
                s, pos = _topk_raw(self.descriptors, self.ids, qq,
                                   self.num_valid, self.scales, k=m,
                                   use_kernel=bool(self.cfg.search.use_pallas),
                                   int4=self.is_int4, mask=mask)
                return s, _pos_to_ids(self.ids, s, pos)

            s, i = run_chunked(run, self.cfg.search.query_chunk, q)
            keep = s >= thr[:, None]
            s = s.masked_fill(~keep, float("-inf"))
            i = torch.where(keep, i, torch.full_like(i, -1))
            counts = range_count(self.descriptors, self.ids, q, thr,
                                 self.scales, int4=self.is_int4, mask=mask,
                                 dim=self.dim)
        s, i = s.cpu().numpy(), i.cpu().numpy()
        if qn2 is not None:
            s = _l2_scores(s, i, qn2)
        return s, i, counts.cpu().numpy().astype(np.int32)

    def _positions(self, names=None, ids=None) -> list[int]:
        """Row positions of exactly one of image ``names`` or dataset
        ``ids``, in the request's order; unknown ones raise ``KeyError``."""
        if (names is None) == (ids is None):
            raise ValueError("pass exactly one of names=, ids=")
        if names is not None:
            pos_by_name = {nm: p for p, nm in enumerate(self.names)}
            missing = [nm for nm in names if nm not in pos_by_name]
            if missing:
                raise KeyError(f"{len(missing)} names not in the index "
                               f"(e.g. {missing[:3]})")
            return [pos_by_name[nm] for nm in names]
        ids_np = self.ids[:self.num_valid].cpu().numpy()
        pos_by_id = {int(v): p for p, v in enumerate(ids_np)}
        want = [int(i) for i in ids]
        missing = [i for i in want if i not in pos_by_id]
        if missing:
            raise KeyError(f"{len(missing)} ids not in the index "
                           f"(e.g. {missing[:3]})")
        return [pos_by_id[i] for i in want]

    def reconstruct(self, names: "Sequence[str] | None" = None,
                    ids: "Sequence[int] | None" = None) -> np.ndarray:
        """Stored rows back out -> ``[n, user_dim]`` f32 numpy, row-aligned
        with the request (exactly one of image ``names`` or dataset
        ``ids``): what the scoring stages see, dequantized as every search
        stage gathers rows (``gather_rows_f32``), without the zero columns
        (and an l2 store's norm column)."""
        pos = self._positions(names=names, ids=ids)
        if not pos:
            return np.zeros((0, self.user_dim), np.float32)
        rows = self._rows_f32_at(torch.tensor(pos, device=self.device))
        return rows[:, :self.user_dim].cpu().numpy()

    # ------------------------------------------------------------------
    def add(self, paths: "Sequence[str] | None" = None, descriptors=None,
            names: "Sequence[str] | None" = None,
            _regional_rows=None) -> int:
        """Index new images in place: image ``paths`` (through the attached
        extractor and its whitening; with an R-MAC re-rank store, one
        combined pass gives the regional rows too) or whitened
        ``descriptors [n, dim]`` with their ``names`` (an l2 index takes
        rows of the caller's width and appends their norm column). New ids
        run from
        ``max(len(names), max id + 1)``. Rows are quantized and written at
        positions ``num_valid...`` while the padded capacity holds them;
        past it the whole store is dequantized and re-padded through
        ``from_descriptors`` to ``max(capacity, 2 N_pad, n_valid + n)``
        (written back into ``cfg``; every int8/int4 row is quantized again,
        as the reference does), which makes existing subsets stale. An
        exact-refine store grows from the rows; the views absorb them.
        On a placed store (``load(mesh=)``) the rows, scales and regional
        rows within capacity go to the shards that hold their positions
        (``ShardedIndex.write_rows``; across processes each process writes
        its own), the placement staying; past capacity the store is gathered
        and re-padded on the mesh's first device, as the reference's re-pad
        lands on one device, and across processes that raises
        ``ValueError``. Returns the number of rows added."""
        reg_new = None
        if paths is not None:
            if self.extractor is None:
                raise ValueError("index has no extractor attached")
            quarantine: list[str] = []
            if self.has_regional and not self.has_refine_store:
                descriptors, reg_new, kept = \
                    self.extractor.extract_paths_with_regional(paths,
                                                               quarantine)
            else:
                descriptors, kept = self.extractor.extract_paths(paths,
                                                                 quarantine)
            names = [os.path.splitext(os.path.basename(paths[i]))[0]
                     for i in kept]
            self.quarantined = list(self.quarantined) + quarantine
        elif descriptors is None or names is None:
            raise ValueError("pass paths=, or descriptors= and names=")
        x = torch.as_tensor(descriptors, device=self.device).float()
        if x.ndim != 2:
            raise ValueError(f"descriptors {tuple(x.shape)}: [n, dim]")
        if self.is_l2 and x.shape[1] == self.dim - 1:
            # rows of the caller's width gain the norm column (merge_from's
            # dequantized donor rows carry it already)
            x = torch.cat([x, 0.5 * (x * x).sum(1, keepdim=True)], 1)
        if self.is_int4 and x.shape[1] == self.dim - 1:
            # the odd width's zero column (nibbles pack in pairs)
            x = torch.nn.functional.pad(x, (0, 1))
        if x.shape[1] != self.dim:
            raise ValueError(f"descriptors have width {x.shape[1]}, the "
                             f"store {self.dim}")
        n_new = len(names)
        if n_new != x.shape[0]:
            raise ValueError(f"{x.shape[0]} rows for {n_new} names")
        if n_new == 0:
            return 0
        if self.has_regional and reg_new is None:
            if self.has_refine_store:
                reg_new = x[:, None, :]
            elif _regional_rows is not None:
                reg_new = _regional_rows
            else:
                raise ValueError("index has a regional re-rank store; "
                                 "add() needs image paths to extend it")

        next_id = max(len(self.names),
                      int(self.ids.max().item()) + 1 if len(self.ids) else 0)
        start, n_pad = self.num_valid, self.n_pad
        new_ids = torch.arange(next_id, next_id + n_new, dtype=torch.int32,
                               device=self.device)
        if start + n_new > n_pad:
            if self.placed and self.placement.mesh.group is not None:
                raise ValueError(
                    f"capacity {n_pad} exceeded ({start} + {n_new}): a store "
                    f"placed across processes cannot re-pad, which would "
                    f"join the whole store on every process; save it and "
                    f"load it into a larger capacity")
            logging.getLogger("instsearch.index").warning(
                "capacity %d exceeded (%d + %d); re-padding%s", n_pad, start,
                n_new, " (the placed store gathered first)" if self.placed
                else "")
            self.gather()
            merged = torch.cat([self._rows_f32_chunk(0, n_pad)[:start], x])
            grown = self.cfg.replace(index=self.cfg.index.replace(
                capacity=max(self.cfg.index.capacity, 2 * n_pad,
                             start + n_new)))
            # the rebuild's refine copy would be of the re-quantized rows;
            # the reference keeps its own rows and pads its store instead
            rebuilt = Index.from_descriptors(
                merged, list(self.names) + list(names),
                grown.replace(index=grown.index.replace(refine_dtype="")),
                original_ids=torch.cat([self.ids[:start],
                                        new_ids]).cpu().numpy(),
                device=self.device, _augmented=self.is_l2)
            del merged
            self.cfg = grown
            self.descriptors, self.ids = rebuilt.descriptors, rebuilt.ids
            self.scales, self.names = rebuilt.scales, rebuilt.names
            self._layout_gen += 1
            if self.regional is not None:
                self._write_regional(start, reg_new,
                                     n_pad_new=self.descriptors.shape[0])
            self._absorb_views(start, n_new)
            return n_new

        rows = torch.nn.functional.pad(x, (0, self.store_dim - self.dim))
        quantize = _QUANTIZE.get(self.cfg.index.dtype)
        qr = quantize(rows) if quantize is not None else None
        if self.placed:
            self.placement.write_rows(
                torch.arange(start, start + n_new, device=self.device),
                {"x": rows} if qr is None else
                {"x": qr.values, "scales": qr.scales.reshape(-1)})
        elif qr is not None:
            self.descriptors[start:start + n_new] = qr.values
            self.scales[:, start:start + n_new] = qr.scales
        else:
            self.descriptors[start:start + n_new] = rows.to(
                self.descriptors.dtype)
        self.ids[start:start + n_new] = new_ids
        self.names = list(self.names) + list(names)
        if self.has_regional:
            self._write_regional(start, reg_new)
        self._absorb_views(start, n_new)
        if self.placed:
            self._replace_placement()
        return n_new

    def _absorb_views(self, start: int, n_new: int) -> None:
        """Route rows ``[start, start + n_new)``, just written, into the
        attached views: the IVF view (rows into its spill), the PQ view
        (frozen-codebook codes at their positions), the IVF-PQ view
        (frozen-quantizer residual codes into its spill) and the
        local-whitening view (rows routed and whitened under the frozen
        bank). A placed store's rows are read through its placement."""
        if self.ivf is not None:
            self.ivf.absorb_add(self, start, n_new)
        if self.pq is not None:
            self.pq.absorb_add(self, start, n_new)
        if self.ivfpq is not None:
            self.ivfpq.absorb_add(self, start, n_new)
        if self.lw is not None:
            self.lw.absorb_add(self, start, n_new)

    def _write_regional(self, start: int, reg_new,
                        n_pad_new: "int | None" = None) -> None:
        """Write new rows ``[n, R, D]`` into the regional store at
        ``start``, quantized per (row, region) for an int8 store (a placed
        store's to the shards that hold them); the store is first padded
        with zero rows to ``n_pad_new`` when the main store was
        re-padded."""
        if n_pad_new is not None and n_pad_new != self.regional.shape[0]:
            old = self.regional.shape[0]
            grown = self.regional.new_zeros((n_pad_new,)
                                            + self.regional.shape[1:])
            grown[:old] = self.regional
            self.regional = grown
            if self.regional_scales is not None:
                sc = self.regional_scales.new_zeros(
                    (n_pad_new, self.regional.shape[1]))
                sc[:old] = self.regional_scales
                self.regional_scales = sc
        reg = torch.as_tensor(reg_new, device=self.device).float()
        n, r, d = reg.shape
        store = self._parts("regional")[0] if self.placed else self.regional
        if store.dtype == torch.int8:
            qr = quantize_rows(reg.reshape(-1, d))
            new = {"regional": qr.values.reshape(n, r, d),
                   "regional_scales": qr.scales.reshape(n, r)}
        else:
            new = {"regional": reg.to(store.dtype)}
        if self.placed:
            self.placement.write_rows(
                torch.arange(start, start + n, device=self.device), new)
            return
        for name, rows in new.items():
            getattr(self, name)[start:start + n] = rows

    def remove(self, names: Sequence[str]) -> int:
        """Remove indexed images by name, in place. Valid rows stay a
        contiguous prefix (the kernels bound the scan by ``num_valid``): the
        surviving rows of the tail ``[n_valid - m, n_valid)``, in ascending
        order, move into the holes below it, in ascending order, rows
        gathered before any write, as the reference moves them. Rows, ids,
        scales, the regional store and its scales, and the PQ view's codes
        move verbatim (no quantization), and the local-whitening view's
        store and clusters; ids past the new count become -1. The IVF and
        IVF-PQ views remap their stored positions (a removed row's slot
        becomes -1, masked like padding).
        ``names`` follow the moves and existing subsets go stale. Unknown
        names raise ``KeyError`` and leave the index unchanged. On a placed
        store (``load(mesh=)``) the moves run on the shards (every moved
        row read by ``ShardedIndex.read_rows``, then each written to its
        hole by ``write_rows``, wherever the two lie; across processes the
        moved rows cross by one ``all_gather`` of their bytes), and the
        placement takes the new ids and valid counts. A live
        ``to_sharded()`` view keeps its old shards: make it again. Returns
        the number of rows removed."""
        pos_by_name = {nm: i for i, nm in enumerate(self.names)}
        missing = [nm for nm in names if nm not in pos_by_name]
        if missing:
            raise KeyError(f"not in index: {missing}")
        rem = {pos_by_name[nm] for nm in names}
        m = len(rem)
        if m == 0:
            return 0
        n_valid = self.num_valid
        new_valid = n_valid - m
        holes = sorted(p for p in rem if p < new_valid)
        tail_survivors = [p for p in range(new_valid, n_valid)
                          if p not in rem]
        if holes:
            src = torch.tensor(tail_survivors, device=self.device)
            dst = torch.tensor(holes, device=self.device)
            if self.placed:     # every moved row read before any write
                self.placement.write_rows(dst,
                                          self.placement.read_rows(src))
                self.ids[dst] = self.ids[src]
            else:
                for t in (self.descriptors, self.ids, self.regional,
                          self.regional_scales):
                    if t is not None:
                        t[dst] = t[src]
                if self.scales is not None:
                    self.scales[:, dst] = self.scales[:, src]
            for view in (self.pq, self.lw):
                if view is not None:
                    view.absorb_remove(src, dst)
        if self.ivf is not None or self.ivfpq is not None:
            pos_map = np.arange(self.n_pad, dtype=np.int32)
            pos_map[sorted(rem)] = -1
            pos_map[tail_survivors] = holes
            pos_map = torch.as_tensor(pos_map, device=self.device)
            for view in (self.ivf, self.ivfpq):
                if view is not None:
                    view.absorb_remove(pos_map)
        self.ids[new_valid:] = -1
        names_arr = np.array(self.names, dtype=object)
        names_arr[holes] = names_arr[tail_survivors]
        self.names = list(names_arr[:new_valid])
        self._name_by_id_len = -1
        self._layout_gen += 1
        if self.placed:
            self._replace_placement()
        COUNTERS.add("images_removed", m)
        return m

    # donor rows merge_from reads and appends at a time into a placed store
    _MERGE_PIECE = 1 << 16

    def merge_from(self, other: "Index") -> int:
        """Append every valid row of ``other`` through :meth:`add` (fresh ids
        in this index's id space, this store's quantization, capacity
        growth, the views absorbing them), with the donor's dequantized
        regional rows. Refused: the index itself, another metric, another
        dim, another ``cfg.extract``, extractors whose weights or whitening
        differ (``_extractor_fingerprint``, when both carry one), shared
        names, and regional stores of another kind or region count.
        Neither index is gathered: a placed donor's rows are read through
        its placement (across processes by one ``all_gather`` of the rows
        each process needs), and into a placed store within its capacity
        they are appended ``_MERGE_PIECE`` rows at a time through the
        placed ``add`` (past capacity, one ``add``, which re-pads). Returns
        the number of rows merged."""
        if other is self:
            raise ValueError("cannot merge an index into itself")
        if other.cfg.index.metric != self.cfg.index.metric:
            raise ValueError(
                f"metric mismatch: {self.cfg.index.metric!r} vs "
                f"{other.cfg.index.metric!r} — an l2 store carries a norm "
                f"column an ip store does not")
        if other.dim != self.dim:
            raise ValueError(f"descriptor dim mismatch: {self.dim} vs "
                             f"{other.dim}")
        if self.cfg.extract.to_json() != other.cfg.extract.to_json():
            raise ValueError(
                "extraction configs differ — descriptors from different "
                "pipelines do not share a space; re-extract one side")
        if (self.extractor is not None and other.extractor is not None
                and _extractor_fingerprint(self.extractor)
                != _extractor_fingerprint(other.extractor)):
            raise ValueError(
                "extractor weight/whitening fingerprints differ — the two "
                "indexes were not built by the same extractor; re-extract "
                "one side")
        dup = set(self.names) & set(other.names)
        if dup:
            raise ValueError(
                f"{len(dup)} duplicate names (e.g. {sorted(dup)[:3]}) — "
                f"names must be unique across the merged index")
        self_rerank = self.has_regional and not self.has_refine_store
        other_rerank = other.has_regional and not other.has_refine_store
        if (self_rerank != other_rerank
                or self.has_refine_store != other.has_refine_store):
            raise ValueError(
                "regional-store kinds differ (R-MAC re-rank vs exact-refine "
                "vs none) — both sides must match")
        if (self_rerank
                and self.regions_per_image != other.regions_per_image):
            raise ValueError(
                f"regional region counts differ: {self.regions_per_image} "
                f"vs {other.regions_per_image}")
        nvb = other.num_valid
        if nvb == 0:
            return 0
        piece = (self._MERGE_PIECE if self.placed
                 and self.num_valid + nvb <= self.n_pad else nvb)
        n = 0
        for s in range(0, nvb, piece):
            cnt = min(piece, nvb - s)
            rows = other._rows_f32_chunk(s, cnt)
            n += self.add(descriptors=rows.to(self.device),
                          names=other.names[s:s + cnt],
                          _regional_rows=other._regional_f32(s, cnt).to(
                              self.device) if self_rerank else None)
        self.quarantined = list(self.quarantined) + list(other.quarantined)
        # the donor's rows join the always-scanned spill of an IVF or IVF-PQ
        # view, which moves the scan toward brute force: warn, as the
        # reference does
        for view, rebuild in ((self.ivf, "build_ivf()"),
                              (self.ivfpq, "build_ivfpq()")):
            if view is None:
                continue
            spill_used = int((view.spill_pos >= 0).sum())
            if spill_used > 0.25 * max(self.num_valid, 1):
                logging.getLogger("instsearch.index").warning(
                    "merge_from absorbed the donor into the always-"
                    "scanned spill: %d of %d rows (%.0f%%) now scan on "
                    "EVERY query regardless of nprobe — rebuild with %s "
                    "over the union to restore the pruned layout",
                    spill_used, self.num_valid,
                    100.0 * spill_used / max(self.num_valid, 1), rebuild)
        return n

    # ------------------------------------------------------------------
    # Persistence. Two forms of the store behind one API, chosen as the
    # reference chooses its own two (at 8 MiB of arrays):
    #   * the port's stream (format "npy_stream"): store/ is a sharded tree
    #     (utils/checkpoint.py), one .npy a reference array in its storage
    #     dtype (bf16 as its bits), written and read shard by shard;
    #   * npz: index.npz (bf16 widened to f32), which the reference reads.
    # Both hold the reference's arrays: its names, its width (no zero
    # columns), its int4 pairing. The backbone's weights go to a file of the
    # port's own (the reference writes an orbax checkpoint, which
    # tools/orbax_to_port.py converts); the reference reads an npz index
    # with ``extractor=None`` or its own extractor, and not the stream.

    _STREAMING_CUTOFF_BYTES = 8 * 1024 * 1024
    STREAM_FORMAT = "npy_stream"

    def _array_state(self) -> dict:
        """The reference's arrays (an l2 store's norm column included, as
        the reference writes it), name -> tensor in its storage dtype, or a
        :class:`~instsearch_torch.utils.checkpoint.Placed` of a placed
        store's parts, each part cut to the reference's form on its own
        device."""
        def ref_rows(x):
            """Stored rows at the reference's width and int4 pairing."""
            if self.is_int4:
                return (x if 2 * x.shape[1] == self.dim else
                        pack_int4(unpack_int4(x)[:, :self.dim]))
            return x[:, :self.dim]

        def leaf(name, fn=None):
            fn = fn or (lambda t: t)
            if self.placed:
                parts = self._parts(name)
                return None if parts is None else Placed(
                    [fn(t) for t in parts], _STORES[name][1],
                    self.placement.mesh)
            t = getattr(self, name)
            return None if t is None else fn(t)

        x = self._parts("descriptors")[0] if self.placed else self.descriptors
        x_key = ("descriptors_int4" if self.is_int4 else "descriptors_int8"
                 if x.dtype == torch.int8 else "descriptors")
        state = {"ids": self.ids.to(torch.int32),
                 x_key: leaf("descriptors", ref_rows),
                 "scales": leaf("scales")}
        w = None if self.extractor is None else self.extractor.whitening
        if w is not None:
            state["whitening_P"] = w.P.float()
            state["whitening_mu"] = w.mu.float()
        if self.has_regional:
            int8 = ((self._parts("regional")[0] if self.placed
                     else self.regional).dtype == torch.int8)
            state["regional_int8" if int8 else "regional"] = \
                leaf("regional")
            state["regional_scales"] = leaf("regional_scales")
        return {k: v for k, v in state.items() if v is not None}

    @staticmethod
    def _npz_array(v) -> np.ndarray:
        """An array of :meth:`_array_state` joined on the host for the npz
        form (a placed one through its mesh's group when it has one),
        bf16 widened to f32."""
        if isinstance(v, Placed):
            v = (v.mesh.gather(v.parts, v.dim) if v.mesh.group is not None
                 else torch.cat([t.cpu() for t in v.parts], v.dim))
        v = v.cpu()
        return (v.float() if v.dtype == torch.bfloat16 else v).numpy()

    def save(self, path: str, streaming: "bool | None" = None) -> None:
        """Write the index to the directory ``path``. ``streaming`` None
        chooses as the reference does: the port's stream (``store/``, a
        sharded tree) when the arrays to write hold at least 8 MiB, the
        regional store counted, else the reference's npz form, which
        ``instsearch_tpu.index.Index.load`` reads too (it leaves the
        extractor to its caller: ``weights_saved`` is false); True or False
        forces the choice. The reference cannot read the stream. A placed
        store (``load(mesh=)``) writes each shard's rows from its own part
        into the stream; the npz form joins them on the host first. The
        backbone's ``state_dict`` goes to ``torch_weights.pt``, from which
        :meth:`load` rebuilds the extractor."""
        os.makedirs(path, exist_ok=True)
        group = self.placement.mesh.group if self.placed else None
        # across processes, the store is written by every process (its own
        # shards) and the rest of the directory by rank 0 alone
        lead = group is None or self.placement.mesh.rank == 0
        state = self._array_state()
        if streaming is None:
            streaming = sum(_leaf_bytes(v) for v in state.values()) \
                >= self._STREAMING_CUTOFF_BYTES
        if streaming:
            save_sharded_pytree(os.path.join(path, "store"), state)
        else:
            arrays = {k: self._npz_array(v) for k, v in state.items()}
            if lead:
                np.savez(os.path.join(path, "index.npz"), **arrays)
            del arrays
        if lead:
            self._save_rest(path, state, streaming)
        if group is not None:
            import torch.distributed as dist
            dist.barrier(group=group)

    def _save_rest(self, path: str, state: dict, streaming: bool) -> None:
        """``meta.json``, the views and the backbone's weights of
        :meth:`save`."""
        dtypes = {k: _leaf_dtype(v) for k, v in state.items()}
        meta = {"names": list(self.names),
                "config": json.loads(self.cfg.to_json()),
                "format": self.STREAM_FORMAT if streaming else "npz",
                "dtypes": dtypes,
                "seed": getattr(self.extractor, "seed", 0),
                "weights_saved": False}
        if self.ivf is not None:
            self.ivf.save(os.path.join(path, "ivf"))
            meta["ivf"] = True
        if self.lw is not None:
            self.lw.save(os.path.join(path, "lw"))
            meta["lw"] = True
        if self.pq is not None:
            self.pq.save(os.path.join(path, "pq"))
            meta["pq"] = True
        if self.ivfpq is not None:
            self.ivfpq.save(os.path.join(path, "ivfpq"))
            meta["ivfpq"] = True
        if self.regional_geom is not None:
            meta["regional_geom"] = np.asarray(self.regional_geom).tolist()
        if self.extractor is not None:
            torch.save(self.extractor.model.state_dict(),
                       os.path.join(path, _WEIGHTS_FILE))
            meta["torch_weights"] = _WEIGHTS_FILE
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump(meta, f)

    @classmethod
    def load(cls, path: str, extractor: Optional[Extractor] = None,
             mesh=None, *,
             device: "torch.device | str | None" = None) -> "Index":
        """An index saved by :meth:`save` (the port's stream or npz) or by
        the reference in its npz form (any row padding), onto ``device``
        (default: the extractor's, else the CUDA card, raising without
        one). The store gains the kernels' zero columns again, int4 rows
        are repacked to the port's pairing, PQ codes padded to words; saved
        IVF, IVF-PQ and local-whitening views come along. The extractor is
        ``extractor``, else rebuilt from the port's weights file; an index
        whose weights were saved as an orbax checkpoint needs
        ``extractor=`` or a conversion by ``tools/orbax_to_port.py``, as
        does the reference's streaming (orbax) form. The stored whitening
        is attached to the extractor. A stream is read from memory maps:
        without ``mesh`` straight from them, with one a shard's rows at a
        time; a missing or mis-shaped ``store/`` file raises.

        ``mesh`` (a :class:`~instsearch_torch.parallel.ShardMesh` or a 2-D
        mesh's shard axis) places the store as it loads: each of this
        process's shards gets its rows of the store, the row scales and the
        regional store, read from the file's rows and moved straight to
        its device, so no device holds a whole-store tensor (with a process
        group, each process places only its own shards; rows are
        process-major). The ids (metadata), the views and the extractor
        with its whitening go to the mesh's first device (``device`` is
        then ignored). Serving runs through the placement (see the module
        docstring); the padded rows must divide among the mesh's shards."""
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        fmt = meta.get("format", "npz")
        if fmt == "orbax":
            raise NotImplementedError(
                f"this index was saved in the reference's streaming (orbax) "
                f"form, which the port does not read: convert it with "
                f"{_CONVERTER} where JAX and orbax are installed")
        if fmt not in ("npz", cls.STREAM_FORMAT):
            raise ValueError(f"unknown index format {fmt!r}")
        cfg = PipelineConfig.from_json(json.dumps(meta["config"]))
        _check_index_cfg(cfg)
        smesh = None
        if mesh is not None:
            from .parallel.mesh import as_shard_mesh
            smesh = as_shard_mesh(mesh)
            dev = torch.empty(0, device=smesh.devices[0]).device
        else:
            dev = (extractor.device if device is None and extractor is not None
                   else resolve_device(device))
        if extractor is None and meta.get("torch_weights"):
            extractor = Extractor(cfg.extract.replace(whiten=False),
                                  seed=int(meta.get("seed", 0)), device=dev)
            extractor.model.load_state_dict(torch.load(
                os.path.join(path, meta["torch_weights"]), map_location=dev))
        elif extractor is None and meta.get("weights_saved"):
            raise ValueError(
                f"this index saved its backbone weights as an orbax "
                f"checkpoint (variables/), which the port does not read: "
                f"convert the index with {_CONVERTER}, or pass extractor= "
                f"built from the same weights (a seeded extractor would "
                f"serve wrong neighbours)")
        if fmt == "npz":
            npz = np.load(os.path.join(path, "index.npz"))
            raw = {k: npz[k] for k in npz.files}
            stored = {k: str(a.dtype) for k, a in raw.items()}
        else:
            # name -> Leaf: raw[name][rows] reads those rows alone from a
            # memory map
            raw = open_tree(os.path.join(path, "store"))
            stored = {k: leaf.dtype for k, leaf in raw.items()}

        def put(name, key=..., dtype=None, to=dev):
            t = tensor_of(raw[name][key], stored[name]).to(to)
            return t if dtype is None else t.to(dtype)

        if extractor is not None and "whitening_P" in raw:
            extractor.whitening = WhiteningParams(
                P=put("whitening_P", dtype=torch.float32,
                      to=extractor.device),
                mu=put("whitening_mu", dtype=torch.float32,
                       to=extractor.device))
        kind = cfg.index.dtype
        int4_key = "descriptors_int4" in raw
        key = ("descriptors_int4" if int4_key else "descriptors_int8"
               if "descriptors_int8" in raw else "descriptors")
        n_pad = raw[key].shape[0]
        dim = raw[key].shape[1] * (2 if int4_key else 1)
        width = _pad_rows(dim, _COLUMN_MULTIPLE[kind])

        def store(lo, hi, to):
            """Stored rows [lo, hi) on ``to``, with the zero columns."""
            if int4_key:
                comps = unpack_int4(put(key, slice(lo, hi), to=to))
                return pack_int4(torch.nn.functional.pad(
                    comps, (0, width - dim)))
            x = put(key, slice(lo, hi), _DTYPES.get(kind, torch.int8), to=to)
            return torch.nn.functional.pad(x, (0, width - dim))

        regional_key = ("regional_int8" if "regional_int8" in raw
                        else "regional" if "regional" in raw else None)
        regional_dtype = (torch.int8 if regional_key == "regional_int8" else
                          _DTYPES[meta["dtypes"]["regional"]]
                          if regional_key else None)
        sources = {
            "descriptors": store,
            "scales": None if "scales" not in raw else
            (lambda lo, hi, to: put("scales", (slice(None), slice(lo, hi)),
                                    torch.float32, to=to)),
            "regional": None if regional_key is None else
            (lambda lo, hi, to: put(regional_key, slice(lo, hi),
                                    regional_dtype, to=to)),
            "regional_scales": None if "regional_scales" not in raw
            else (lambda lo, hi, to: put("regional_scales", slice(lo, hi),
                                         torch.float32, to=to))}
        for name in ("ids", "scales", regional_key, "regional_scales"):
            if name in raw and raw[name].shape[-1 if name == "scales"
                                               else 0] != n_pad:
                raise ValueError(f"{name} holds {raw[name].shape}, the "
                                 f"store {n_pad} rows")
        if smesh is None:
            whole = {name: None if src is None else src(0, n_pad, dev)
                     for name, src in sources.items()}
            idx = cls(whole["descriptors"], put("ids", dtype=torch.int32),
                      list(meta["names"]), cfg, extractor,
                      scales=whole["scales"], dim=dim)
            idx.regional = whole["regional"]
            idx.regional_scales = whole["regional_scales"]
        else:
            if n_pad % smesh.num_shards:
                raise ValueError(
                    f"{n_pad} padded rows do not divide among "
                    f"{smesh.num_shards} shards; load without mesh= and "
                    f"to_sharded() a mesh that divides them")
            c = n_pad // smesh.num_shards
            first = smesh.first_shard
            parts = {name: None if src is None else
                     [src((first + j) * c, (first + j + 1) * c, d)
                      for j, d in enumerate(smesh.devices)]
                     for name, src in sources.items()}
            idx = cls(None, put("ids", dtype=torch.int32), list(meta["names"]),
                      cfg, extractor, dim=dim)
        if meta.get("regional_geom") is not None:
            idx.regional_geom = np.asarray(meta["regional_geom"], np.float32)
        if meta.get("ivf"):
            idx.ivf = IVFIndex.load(os.path.join(path, "ivf"), device=dev)
        if meta.get("pq"):
            idx.pq = PQView.load(os.path.join(path, "pq"), device=dev)
        if meta.get("ivfpq"):
            idx.ivfpq = IVFPQView.load(os.path.join(path, "ivfpq"),
                                       device=dev)
        if meta.get("lw"):
            idx.lw = LocalWhiteningView.load(os.path.join(path, "lw"),
                                             device=dev)
        if smesh is not None:
            idx.placement = idx._sharded_view(smesh, parts)
        return idx

    def evaluate(self, dataset, protocol: str = "medium", search_cfg=None,
                 sharded: bool = False, mesh=None) -> dict:
        """Full protocol metrics on a RetrievalDataset (eval/evaluate.py).
        ``sharded=True`` ranks, expands and re-ranks through
        ``to_sharded(mesh)``: the same results, row-sharded. A placed store
        evaluates through its own placement."""
        from .eval.evaluate import evaluate_index
        sidx = self.to_sharded(mesh=mesh) if sharded else self.placement
        return evaluate_index(self, dataset, protocol, search_cfg,
                              sharded_index=sidx)

    def to_sharded(self, mesh=None, use_pallas: "bool | None" = None):
        """This index row-sharded over a shard mesh
        (``parallel/sharded_index.py``): a ``ShardedIndex`` serving the same
        ids, with the regional store (or the refine copy) and its grid
        geometry, the local-whitening view's store, clusters and bank, and
        the IVF-PQ view (``attach_ivfpq``). ``mesh`` defaults to
        ``make_mesh(num_shards)`` (every
        visible CUDA device when the config names no shards), which raises
        where there are fewer devices than shards: to hold several shards
        on one device, pass ``make_mesh(S, devices=[device] * S)``.
        ``use_pallas`` defaults to the index's own route, so CUDA shards
        launch the kernels. On the store's own device the shards are views
        of it. ``mesh`` may be a 2-D mesh (its ``'shard'`` axis). A placed
        store (``load(mesh=)``) with the same mesh, or none, gives a view
        of its parts themselves, uncopied, as they stand after any mutation
        (with the current ids and valid counts); another mesh gathers it
        first."""
        from .parallel import as_shard_mesh, make_mesh
        p = self.placement
        if p is not None and (mesh is None or as_shard_mesh(mesh) == p.mesh):
            return self._sharded_view(p.mesh, {
                name: self._parts(name) for name in _STORES}, use_pallas)
        self.gather()
        if mesh is None:
            n = self.cfg.index.num_shards
            mesh = make_mesh(n if n > 1 else None)
        return self._sharded_view(mesh, {
            name: getattr(self, name) for name in _STORES}, use_pallas)

    def _sharded_view(self, mesh, store: dict,
                      use_pallas: "bool | None" = None):
        """A ``ShardedIndex`` over ``mesh`` of ``store`` (name -> whole
        tensor, or one placed part per local shard, or None) with this
        index's ids, config, regional geometry and views."""
        from .parallel import ShardedIndex
        if use_pallas is None:
            use_pallas = bool(self.cfg.search.use_pallas)
        lw = self.lw
        sidx = ShardedIndex(store["descriptors"], self.ids, mesh=mesh,
                            k=self.cfg.search.k, use_pallas=use_pallas,
                            scales=store["scales"],
                            regional=store["regional"],
                            regional_scales=store["regional_scales"],
                            query_chunk=self.cfg.search.query_chunk,
                            int4=self.is_int4,
                            regional_geom=self.regional_geom, dim=self.dim,
                            lw_store=None if lw is None else lw.store,
                            lw_assign=None if lw is None else lw.assign,
                            lw_params=None if lw is None else lw.params,
                            l2=self.is_l2)
        if self.ivfpq is not None:
            sidx.attach_ivfpq(self.ivfpq)
        return sidx

    def full_ranking(self, queries) -> np.ndarray:
        """[Q, N] ranked original dataset ids best-first (valid rows only),
        for protocol evaluation. Padding (-inf) sorts last and is cut."""
        q = self._match_query_dim(
            torch.as_tensor(queries, device=self.device).float())
        if self.placed:
            return self.placement.full_ranking(q)
        scores = masked_scores(self.descriptors, q, scales=self.scales,
                               ids=self.ids, int4=self.is_int4)
        order = torch.sort(scores, dim=1, descending=True, stable=True)[1]
        return self.ids[order][:, :self.num_valid].cpu().numpy()
