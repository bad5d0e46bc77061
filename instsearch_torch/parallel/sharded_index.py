"""Row-sharded search (port of ``instsearch_tpu/parallel/sharded_index.py``:
the exact stages over bf16, f32, int8 and int4 stores, and the IVF-PQ
cascade).

The ``[N_pad, W]`` store is cut into S row shards over a :class:`ShardMesh`
(``parallel/mesh.py``); the query is replicated. Each shard runs the fused
top-k kernel of its store's kind on its own rows (K1 for float rows, K2 for
int8, K3 for int4; on a CPU shard their plain versions), or the scoring
oracle where the index's route is off or ``k`` passes the kernels'
``K_MAX``, as ``Index.search`` routes. The only cross-shard traffic is the
reference's: one gather of ``[Q, S*k]`` candidates (scores and dataset
ids), merged by a stable descending sort, so ties go to the lowest shard and
so to the lowest global row, as ``lax.top_k`` over the shard-ordered gather
gives them. Alpha-QE gathers the dequantized candidate rows too; the
regional re-rank and the local-whitening re-score gather a global
top-``depth`` membership, score their own candidates on each shard and
gather those scores; diffusion gathers the candidates' rows and diffuses
the merged top-``depth`` (the same graph on every process); evaluation
gathers the whole score matrix. The gathers, merges and membership tests are plain tensor
code, as the reference computes them outside any Pallas kernel.

Row padding lies at the store's tail, so a shard's valid rows number
``clip(num_valid - shard * C, 0, C)``; a shard with none (whole trailing
shards can be padding) answers ``(-inf, -1)`` without a launch.

A subset filter (``search/subset.py``) is cut by ``place_subset`` into each
shard's ``[1, C]`` slice of its mask, on the shard's device, the operand of
that shard's kernel (or oracle) in every stage, as the reference shards
the mask like the row scales.

The IVF-PQ cascade (``sharded_ivfpq``) shards its codes along the buckets'
CAPACITY axis, as the reference: every shard holds ``[C, M/S, m/2]`` of
every bucket and 1/S of the spill, so the replicated probe selection finds
the single device's slots. Each shard selects its own top-min(depth,
slots) by ADC, the selections are gathered and merged to the global
top-depth, each shard re-scores exactly the candidates whose rows it holds,
and one sum over the shards (a gather, then a sum where one shard gives the
score and the rest zeros) assembles the scores.

Range search (``sharded_range``) takes its members from the sharded merge of
the top-k, cut at the threshold, and its exhaustive counts from a pass over each
shard's own rows (``search/bruteforce.py::range_count``, chunk by chunk,
never a ``[Q, C]`` matrix), summed over the local shards and, with a process
group, by one ``all_reduce``. An l2 store (``l2=True``) carries the
``||x||^2/2`` column, and queries of the user's width gain its ``-1``
column; scores stay in that space (``Index`` converts them).

On a 2-D mesh (``make_mesh_2d``) the rows shard over its ``'shard'`` axis
(else its first), at position 0 of the other axis: one process needs one
replica of the store.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..kernels.topk_matmul import (K_MAX, topk_matmul, topk_matmul_int4,
                                   topk_matmul_int8)
from ..ops.local_whiten import LocalWhiteningParams
from ..search.bruteforce import (gather_rows_f32, masked_scores, range_count,
                                 search_topk, select_topk)
from ..search.diffusion import diffusion_rerank_from_candidates
from ..search.ivfpq import _adc_select
from ..search.lw_rerank import lw_candidate_scores, whiten_all_clusters
from ..search.qe import expand_from_candidates
from ..search.rerank import fused_scores, region_similarities
from ..search.spatial import build_vote_matrix
from ..utils.chunking import run_chunked
from .mesh import ShardMesh, as_shard_mesh, make_mesh, replicate, shard_rows

_NEG = float("-inf")
# the per-row stores of a shard (``Shard`` fields) that mutations move
_ROW_FIELDS = ("x", "scales", "regional", "regional_scales")


class Shard(NamedTuple):
    """One shard's slice of the store, on its device: ``x [C, W]`` (int4:
    ``[C, W/2]``), its dataset ``ids [C]``, row ``scales [1, C]`` (int8,
    int4), the regional store ``[C, R, D]`` and its ``[C, R]`` scales (int8),
    its count of valid rows, and the local-whitening view's whitened rows
    ``[C, dim]`` and their clusters ``[C]``."""
    x: torch.Tensor
    ids: torch.Tensor
    scales: "torch.Tensor | None"
    regional: "torch.Tensor | None"
    regional_scales: "torch.Tensor | None"
    num_valid: int
    lw_store: "torch.Tensor | None" = None
    lw_assign: "torch.Tensor | None" = None


def _pad_cols(t: torch.Tensor, width: int, value) -> torch.Tensor:
    if t.shape[1] >= width:
        return t
    return torch.nn.functional.pad(t, (0, width - t.shape[1]), value=value)


def _local_topk(sh: Shard, q: torch.Tensor, kk: int, *, use_kernel: bool,
                int4: bool, mask=None):
    """Per-shard top-``kk`` -> ``(scores, local positions)``, each ``[Q,
    kk]``, empty slots ``(-inf, -1)``. ``kk`` past the shard's C rows is
    clamped for the selection and padded back, so every caller's gather
    stays ``S * kk`` wide. ``use_kernel``: the fused kernel of the store's
    kind, else the scoring oracle (:func:`_route`). ``mask``: the shard's
    ``[1, C]`` slice of a subset mask."""
    kk_req, kk = kk, min(kk, sh.x.shape[0])
    if sh.num_valid == 0:
        s = q.new_full((q.shape[0], kk), _NEG, dtype=torch.float32)
        pos = torch.full((q.shape[0], kk), -1, dtype=torch.int32,
                         device=q.device)
    elif not use_kernel:
        s, pos = search_topk(sh.x, q, k=kk, ids=sh.ids, scales=sh.scales,
                             int4=int4, mask=mask)
    elif int4:
        s, pos = topk_matmul_int4(sh.x, sh.scales, q, k=kk,
                                  num_valid=sh.num_valid, mask=mask)
    elif sh.x.dtype == torch.int8:
        s, pos = topk_matmul_int8(sh.x, sh.scales, q, k=kk,
                                  num_valid=sh.num_valid, mask=mask)
    else:
        s, pos = topk_matmul(sh.x, q, k=kk, num_valid=sh.num_valid,
                             mask=mask)
    return _pad_cols(s, kk_req, _NEG), _pad_cols(pos, kk_req, -1)


def _route(use_pallas: bool, k: int) -> bool:
    """The kernel route for a selection of ``k``: the index's route, and
    ``k`` within the kernels' ``K_MAX`` (as ``Index.search``, so a shard
    takes the route the single-device store takes for the same k)."""
    return use_pallas and k <= K_MAX


def _gather_rows_f32(sh: Shard, pos: torch.Tensor, int4: bool
                     ) -> torch.Tensor:
    """Dequantized f32 rows at local ``pos [Q, n]`` (zeros for empty
    slots) -> ``[Q, n, D]``."""
    rows = gather_rows_f32(sh.x, pos.clamp(min=0), sh.scales, int4=int4)
    return torch.where((pos >= 0)[..., None], rows,
                       torch.zeros((), device=rows.device))


def merge_topk(scores: torch.Tensor, pos: torch.Tensor, kk: int, c: int,
               ids: torch.Tensor, k: int):
    """The merge of gathered candidates: ``scores/pos [Q, S*kk]``, each
    shard's ``kk`` scores and local positions in global shard order, shards
    of ``c`` rows -> ``(scores [Q, k], dataset ids [Q, k], global rows [Q,
    k])``. A stable descending sort, so ties keep the gather's order: the
    lowest shard, then its lowest row. The winners' rows are mapped to
    ``ids`` (all ``N_pad`` of them) once, after the merge; empty slots and
    slots past ``S*kk`` come back ``(-inf, -1, -1)``."""
    s, j = select_topk(scores, k)
    jj = j.clamp(min=0).long()
    rows = torch.gather(pos, 1, jj).long() + (jj // kk) * c
    rows = torch.where(j >= 0, rows, torch.full_like(rows, -1))
    out = torch.where(j >= 0, ids[rows.clamp(min=0)], torch.full_like(j, -1))
    return s, out, rows


def _masks(shards, masks):
    """Each local shard's mask slice (``ShardedIndex.place_subset``), or
    None for each."""
    return [None] * len(shards) if masks is None else masks


def _gather_topk(mesh: ShardMesh, shards, qs, kk: int, use_kernel: bool,
                 int4: bool, masks=None):
    """Every shard's top-``kk`` gathered -> ``(scores, positions)`` ``[Q,
    S*kk]`` in global shard order, and the local ``(scores, positions)``
    of each local shard."""
    local = [_local_topk(sh, q, kk, use_kernel=use_kernel, int4=int4,
                         mask=m)
             for sh, q, m in zip(shards, qs, _masks(shards, masks))]
    return (mesh.gather([s for s, _ in local]),
            mesh.gather([p for _, p in local]), local)


def sharded_topk(mesh: ShardMesh, shards, qs, ids: torch.Tensor, k: int, *,
                 use_pallas: bool, int4: bool, masks=None):
    """The sharded search: per-shard top-k, one gather of ``[Q, S*k]``,
    the merge -> ``(scores [Q, k], dataset ids [Q, k])``. ``qs``: the query
    on each local shard's device (``replicate``); ``ids``: the dataset ids
    of all rows, on the first device; ``masks``: each local shard's subset
    mask slice, or None."""
    s_all, p_all, _ = _gather_topk(mesh, shards, qs, k, _route(use_pallas, k),
                                   int4, masks)
    s, out, _ = merge_topk(s_all, p_all, k, shards[0].x.shape[0], ids, k)
    return s, out


def sharded_expand(mesh: ShardMesh, shards, qs, qe_n: int, alpha: float, *,
                   use_pallas: bool, int4: bool, masks=None,
                   include_query: bool = True) -> torch.Tensor:
    """Alpha-QE expansion (round 1 of :func:`sharded_qe_topk`): per-shard
    top-``qe_n`` and its dequantized rows, gathered; the merged top-``qe_n``
    expands the query -> ``[Q, D]`` f32 unit-norm on the first device
    (arXiv:1711.02512 §5). Evaluation ranks the whole store with it.
    ``include_query=False`` is αDBA's database-side weighting (the query is
    a stored row, its own top-1)."""
    s_parts, r_parts = [], []
    for sh, q, m in zip(shards, qs, _masks(shards, masks)):
        s, pos = _local_topk(sh, q, qe_n, use_kernel=_route(use_pallas, qe_n),
                             int4=int4, mask=m)
        s_parts.append(s)
        r_parts.append(_gather_rows_f32(sh, pos, int4))
    s_all = mesh.gather(s_parts)                               # [Q, S*n]
    r_all = mesh.gather(r_parts)                               # [Q, S*n, D]
    top_s, j = select_topk(s_all, qe_n)
    rows = torch.take_along_dim(r_all, j.clamp(min=0).long()[..., None], 1)
    rows = torch.where((j >= 0)[..., None], rows,
                       torch.zeros((), device=rows.device))
    return expand_from_candidates(qs[0], top_s, rows, alpha,
                                  include_query=include_query)


def sharded_qe_topk(mesh: ShardMesh, shards, qs, ids: torch.Tensor, k: int,
                    qe_n: int, alpha: float, *, use_pallas: bool, int4: bool,
                    masks=None):
    """Search with alpha-QE: round 1 (:func:`sharded_expand`, two gathers),
    then :func:`sharded_topk` with the expanded query."""
    q_exp = sharded_expand(mesh, shards, qs, qe_n, alpha,
                           use_pallas=use_pallas, int4=int4, masks=masks)
    return sharded_topk(mesh, shards, replicate(mesh, q_exp), ids, k,
                        use_pallas=use_pallas, int4=int4, masks=masks)


def sharded_scores(mesh: ShardMesh, shards, qs, *, int4: bool
                   ) -> torch.Tensor:
    """The full ``[Q, N_pad]`` score matrix, padding -inf: each shard's
    scoring oracle (``masked_scores``), gathered along the rows."""
    return mesh.gather([masked_scores(sh.x, q, scales=sh.scales, ids=sh.ids,
                                      int4=int4)
                        for sh, q in zip(shards, qs)])


def sharded_rerank(mesh: ShardMesh, shards, qs, qregs, ids: torch.Tensor,
                   k: int, depth: int, *, fuse_weight: float = 1.0,
                   use_pallas: bool, int4: bool, spatial_weight: float = 0.0,
                   votes=None, masks=None):
    """Regional re-ranking over the sharded regional store, the reference's
    three steps:

      1. per-shard top-``min(depth, C)`` (enough to cover the global
         top-``depth``: a shard can give at most its rows), gathered; the
         replicated global top-``depth`` set;
      2. each shard scores the regions of its own candidates that are
         members of that set (``region_similarities`` on local positions,
         int8 scales folded into the similarities), plus the spatial vote
         when ``spatial_weight > 0`` (``votes``: the vote matrix on each
         local device); non-members -inf;
      3. the fused scores gathered and merged to ``[Q, k]``, padded with
         ``(-inf, -1)`` past the gathered width.

    Membership is by global row, where the reference compares dataset ids:
    the same set wherever ids are unique, as an index's are. The fused
    score is the single-device stage's (``search/rerank.py::fused_scores``)."""
    c = shards[0].x.shape[0]
    local_k = min(depth, c)
    # the route of the single-device stage's top-depth
    s_all, p_all, local = _gather_topk(mesh, shards, qs, local_k,
                                       _route(use_pallas, depth), int4, masks)
    glob = merge_topk(s_all, p_all, local_k, c, ids, depth)[2]
    fused_parts = []
    for j, (sh, qreg, (s, pos)) in enumerate(zip(shards, qregs, local)):
        rows = pos.long() + (mesh.first_shard + j) * c
        member = ((rows[:, :, None] == glob.to(pos.device)[:, None, :])
                  .any(dim=2) & (pos >= 0))
        sim = region_similarities(sh.regional, pos, qreg, sh.regional_scales)
        fused_parts.append(fused_scores(
            sim, s, member, fuse_weight=fuse_weight,
            spatial_weight=spatial_weight,
            vote_matrix=None if votes is None else votes[j]))
    s, out, _ = merge_topk(mesh.gather(fused_parts), p_all, local_k, c, ids,
                           k)
    return s, out


def sharded_diffusion(mesh: ShardMesh, shards, qs, ids: torch.Tensor,
                      k: int, depth: int, *, knn: int, alpha: float,
                      iters: int, seeds: int, use_pallas: bool, int4: bool,
                      masks=None):
    """Diffusion re-ranking over the sharded store, the reference's steps:
    per-shard top-``min(depth, C)`` and their dequantized rows, gathered
    (scores, positions and rows); the merged global top-``depth`` and its
    rows diffused by the single-device stage's
    ``diffusion_rerank_from_candidates``, on the first device of every
    process -> ``(scores [Q, k], dataset ids [Q, k])``."""
    c = shards[0].x.shape[0]
    local_k = min(depth, c)
    use_kernel = _route(use_pallas, depth)
    s_parts, p_parts, r_parts = [], [], []
    for sh, q, m in zip(shards, qs, _masks(shards, masks)):
        s, pos = _local_topk(sh, q, local_k, use_kernel=use_kernel,
                             int4=int4, mask=m)
        s_parts.append(s)
        p_parts.append(pos)
        r_parts.append(_gather_rows_f32(sh, pos, int4))
    s_all, p_all = mesh.gather(s_parts), mesh.gather(p_parts)
    r_all = mesh.gather(r_parts)                               # [Q, S*lk, D]
    top_g, j = select_topk(s_all, min(depth, s_all.shape[1]))
    jj = j.clamp(min=0).long()
    rows = torch.gather(p_all, 1, jj).long() + (jj // local_k) * c
    rows = torch.where(j >= 0, rows, torch.full_like(rows, -1))
    cand = torch.take_along_dim(r_all, jj[..., None], 1)
    return diffusion_rerank_from_candidates(
        ids, top_g, rows, cand, k=k, knn=knn, alpha=alpha, iters=iters,
        seeds=seeds)


def sharded_lw(mesh: ShardMesh, shards, qs, ids: torch.Tensor, k: int,
               depth: int, params: LocalWhiteningParams, *, use_pallas: bool,
               int4: bool, masks=None):
    """Local-whitening re-scoring over the sharded whitened store, the
    reference's steps: per-shard top-``min(depth, C)``, gathered, the
    global top-``depth`` membership; the query whitened by every expert
    once on the first device (``params`` lives there) and sent to each
    shard's device; each shard re-scores its member candidates from its
    own rows of the whitened store, non-members -inf; the scores gathered
    and merged to ``[Q, k]``. Membership is by global row, as in
    :func:`sharded_rerank`."""
    c = shards[0].x.shape[0]
    local_k = min(depth, c)
    s_all, p_all, local = _gather_topk(mesh, shards, qs, local_k,
                                       _route(use_pallas, depth), int4, masks)
    glob = merge_topk(s_all, p_all, local_k, c, ids, depth)[2]
    q_all = whiten_all_clusters(qs[0][:, :params.mu.shape[-1]], params.P,
                                params.mu)                     # [Q, E, dim]
    parts = []
    for j, (sh, (s, pos)) in enumerate(zip(shards, local)):
        rows = pos.long() + (mesh.first_shard + j) * c
        member = ((rows[:, :, None] == glob.to(pos.device)[:, None, :])
                  .any(dim=2) & (pos >= 0))
        sc = lw_candidate_scores(sh.lw_store, sh.lw_assign, pos,
                                 q_all.to(pos.device))
        parts.append(torch.where(member, sc, torch.full_like(sc, _NEG)))
    s, out, _ = merge_topk(mesh.gather(parts), p_all, local_k, c, ids, k)
    return s, out


def sharded_range(mesh: ShardMesh, shards, qs, ids: torch.Tensor, thr,
                  m: int, *, use_pallas: bool, int4: bool, dim: int,
                  masks=None):
    """Range search over the shards: the members are :func:`sharded_topk`'s
    top-``m`` cut at ``thr`` (``[Q]`` f32, one threshold a query, on the
    first device), the slots past them ``(-inf, -1)``; the counts are each
    shard's ``range_count`` over its own rows (the first ``dim`` columns,
    dequantized to f32, products in f64, so the routes' counts agree to
    f64 rounding), summed on the first device and
    across processes by one ``all_reduce`` -> ``(scores [Q, m], dataset ids
    [Q, m], counts [Q] int64)``."""
    s, i = sharded_topk(mesh, shards, qs, ids, m, use_pallas=use_pallas,
                        int4=int4, masks=masks)
    keep = s >= thr[:, None]
    s = s.masked_fill(~keep, _NEG)
    i = torch.where(keep, i, torch.full_like(i, -1))
    first = mesh.devices[0]
    counts = sum(range_count(sh.x, sh.ids, q, thr.to(q.device), sh.scales,
                             int4=int4, mask=mk, dim=dim).to(first)
                 for sh, q, mk in zip(shards, qs, _masks(shards, masks)))
    if mesh.group is not None:
        import torch.distributed as dist
        dist.all_reduce(counts, group=mesh.group)
    return s, i, counts


class ShardIVFPQ(NamedTuple):
    """One shard's slice of an IVF-PQ view, on its device: the codes and
    positions of its ``M/S`` slots of every bucket, its ``1/S`` of the spill,
    and the replicated centroids, codebook and rotation, in the order of
    ``search/ivfpq.py::_adc_select``'s arguments."""
    centroids: torch.Tensor
    codes: torch.Tensor
    bucket_pos: torch.Tensor
    spill_codes: torch.Tensor
    spill_pos: torch.Tensor
    spill_cluster: torch.Tensor
    pq_centroids: torch.Tensor
    rotation: "torch.Tensor | None"


def _shard_sum(mesh: ShardMesh, parts) -> torch.Tensor:
    """The reference's psum where exactly one shard holds each entry and the
    others zeros: the parts gathered along a new shard axis and summed (x +
    0 is exact), on the first device of every process."""
    return mesh.gather([p[:, None] for p in parts]).sum(dim=1)


def sharded_ivfpq(mesh: ShardMesh, shards, views, qs, ids: torch.Tensor,
                  k: int, depth: int, nprobe: int, *, int4: bool,
                  qe_n: int = 0, qe_alpha: float = 3.0, mask=None):
    """The IVF-PQ cascade over the capacity-sharded codes (the reference's
    ``sharded_ivfpq_fn``): per shard the ADC selection of
    ``search/ivfpq.py::_adc_select`` over its slice of the probed buckets
    (the probes chosen identically on every shard), gathered; the global
    top-``depth`` by ADC score; each shard's exact f32 re-score of the
    candidates whose rows it holds (global positions), one sum; the re-sort.
    ``qe_n > 0`` expands the query with the top-``qe_n`` rows first, as the
    single-device composite. ``mask``: the ``[1, N_pad]`` subset mask on
    each local shard's device (replicated: slots hold global positions).
    -> ``(scores [Q, k], dataset ids [Q, k])``."""
    c = shards[0].x.shape[0]
    lo = [(mesh.first_shard + j) * c for j in range(len(shards))]
    masks = mask if mask is not None else [None] * len(shards)

    def cascade(q_by_dev):
        sel = [_adc_select(*v, q, m, depth=depth, nprobe=nprobe)
               for v, q, m in zip(views, q_by_dev, masks)]
        s_all = mesh.gather([s for s, _ in sel])
        p_all = mesh.gather([p for _, p in sel])
        dd = min(depth, s_all.shape[1])
        g_s, g_j = select_topk(s_all, dd)
        g_pos = torch.gather(p_all, 1, g_j.clamp(min=0).long())
        g_pos = torch.where(g_s > _NEG, g_pos, torch.full_like(g_pos, -1))
        exact_parts, row_parts = [], []
        for sh, q, l0 in zip(shards, q_by_dev, lo):
            gp = g_pos.to(q.device)
            loc = gp - l0
            inr = (gp >= 0) & (loc >= 0) & (loc < c)
            rows = _gather_rows_f32(sh, torch.where(inr, loc, -1), int4)
            exact_parts.append(torch.where(
                inr, torch.einsum("bkd,bd->bk", rows, q),
                torch.zeros((), device=q.device)))
            row_parts.append(rows)
        exact = _shard_sum(mesh, exact_parts).masked_fill(g_pos < 0, _NEG)
        exact, order = torch.sort(exact, dim=1, descending=True, stable=True)
        g_pos = torch.gather(g_pos, 1, order)
        g_pos = torch.where(exact > _NEG, g_pos, torch.full_like(g_pos, -1))
        return exact, g_pos, row_parts, order

    qs = [q.float() for q in qs]
    if qe_n:
        s, _, row_parts, order = cascade(qs)
        top = [torch.take_along_dim(r, order.to(r.device)[:, :qe_n, None], 1)
               for r in row_parts]
        rows = _shard_sum(mesh, top)                            # [Q, n, D]
        q_exp = expand_from_candidates(qs[0], s[:, :qe_n], rows, qe_alpha)
        qs = replicate(mesh, q_exp)
    exact, g_pos, _, _ = cascade(qs)
    out = torch.where(g_pos >= 0, ids[g_pos.clamp(min=0).long()],
                      torch.full_like(g_pos, -1))
    kk = min(k, exact.shape[1])
    return (_pad_cols(exact[:, :kk], k, _NEG), _pad_cols(out[:, :kk], k, -1))


class ShardedIndex:
    """The store row-sharded over a :class:`ShardMesh`.

    ``descriptors``: this process's rows (all of them in a single process),
    ``[N_local, W]`` bf16/f32/int8 or packed int4 ``[N_local, W/2]`` (with
    ``int4=True``); ``ids``: the dataset ids of ALL ``N_pad`` rows (-1 for
    padding), identical on every process (ids are metadata: each process
    maps merged winners and full rankings to ids itself); ``scales``: this
    process's ``[1, N_local]`` row scales (int8, int4);
    ``regional``/``regional_scales``: this process's rows of the
    re-rank store ``[N_local, R, D]`` and its ``[N_local, R]`` scales (an
    int8 store); ``regional_geom``: the R-MAC grid's ``[R, 3]`` geometry for
    the spatial vote; ``dim``: the descriptor width queries come in
    (default: the stored width), padded with the store's zero columns;
    ``lw_store``/``lw_assign``: this process's rows of a local-whitening
    view's whitened store ``[N_local, dim]`` and clusters, with its bank
    ``lw_params`` (``LocalWhiteningParams``, kept on the first device).
    ``use_pallas`` is the kernel route (a CUDA shard launches the kernels,
    a CPU shard takes their plain versions), on by default as in
    ``SearchConfig``; off, the scoring oracle. ``l2``: the store carries an
    l2 index's ``||x||^2/2`` column at column ``dim - 1`` (``Index.is_l2``),
    and queries one narrower gain the ``-1`` there.
    ``mesh``: a :class:`ShardMesh` or a 2-D mesh (its ``'shard'`` axis).
    ``descriptors``, ``scales``, ``regional`` and ``regional_scales`` may
    also come placed, one tensor per local shard on its device (the rows of
    ``Index.load(mesh=)``): the shards are then those tensors, uncopied.
    Results are tensors on the mesh's first device, the same on every
    process."""

    def __init__(self, descriptors, ids, mesh: "ShardMesh | None" = None,
                 k: int = 10, use_pallas: bool = True, *, regional=None,
                 scales=None, regional_scales=None, query_chunk: int = 128,
                 int4: bool = False, regional_geom=None,
                 dim: "int | None" = None, lw_store=None, lw_assign=None,
                 lw_params: "LocalWhiteningParams | None" = None,
                 l2: bool = False):
        self.mesh = as_shard_mesh(mesh or make_mesh())
        self.axis = self.mesh.axis
        placed = isinstance(descriptors, (list, tuple))
        x = descriptors[0] if placed else torch.as_tensor(descriptors)
        ids_all = torch.as_tensor(ids).to(torch.int32)
        n, s = ids_all.shape[0], self.mesh.num_shards
        if n % s:
            raise ValueError(f"padded rows {n} not divisible by {s} shards")
        c = n // s
        local_rows = (sum(t.shape[0] for t in descriptors) if placed
                      else x.shape[0])
        if local_rows != c * self.mesh.num_local:
            raise ValueError(
                f"{local_rows} local rows; {self.mesh.num_local} local "
                f"shards of {c} rows ({n} ids over {s} shards) need "
                f"{c * self.mesh.num_local}")
        if x.dtype not in (torch.bfloat16, torch.float32, torch.int8):
            raise ValueError(f"store dtype {x.dtype}: bfloat16, float32, "
                             f"int8 or packed int4")
        if x.dtype == torch.int8 and scales is None:
            raise ValueError("int8/int4 descriptors need per-row scales")
        if regional is not None and (
                regional[0] if isinstance(regional, (list, tuple))
                else torch.as_tensor(regional)).dtype == torch.int8 \
                and regional_scales is None:
            raise ValueError("int8 regional store needs per-region scales")
        if ((lw_store is None) != (lw_assign is None)
                or (lw_store is None) != (lw_params is None)):
            raise ValueError("local whitening needs lw_store, lw_assign and "
                             "lw_params together")
        # every row's dataset id on the first device, where merges map
        # their winners and full rankings their orders
        self._ids = ids_all.to(self.mesh.devices[0])
        self.num_valid = int((self._ids >= 0).sum())
        self.num_rows = n
        self.rows_per_shard = c
        self.int4 = int4
        self.l2 = l2
        self.descriptors = descriptors if placed else x
        self.regional = regional
        self.regional_geom = regional_geom
        self.default_k = k
        self.use_pallas = bool(use_pallas)
        self.query_chunk = query_chunk
        self.store_dim = 2 * x.shape[1] if int4 else x.shape[1]
        self.dim = self.store_dim if dim is None else dim
        self._votes = None
        self.ivfpq = None         # attach_ivfpq's slices, one per shard
        self.lw_params = (None if lw_params is None else LocalWhiteningParams(
            *(t.to(self.mesh.devices[0]) for t in lw_params)))

        first = self.mesh.first_shard
        local_ids = ids_all[first * c:(first + self.mesh.num_local) * c]

        def split(t, dim=0):
            if t is None:
                return [None] * self.mesh.num_local
            if isinstance(t, (list, tuple)):       # placed: one per shard
                if len(t) != self.mesh.num_local or any(
                        p.shape[dim] != c or p.device != torch.empty(
                            0, device=d).device
                        for p, d in zip(t, self.mesh.devices)):
                    raise ValueError(
                        f"placed parts: one tensor of {c} rows per local "
                        f"shard, on its device")
                return list(t)
            return shard_rows(self.mesh, torch.as_tensor(t), dim=dim)

        self.shards = [
            Shard(xs, ids_s, sc, reg, rsc,
                  max(0, min(self.num_valid - (first + j) * c, c)), lws, lwa)
            for j, (xs, ids_s, sc, reg, rsc, lws, lwa) in enumerate(zip(
                split(descriptors if placed else x), split(local_ids),
                split(scales, 1),
                split(regional), split(regional_scales), split(lw_store),
                split(lw_assign)))]

    # ------------------------------------------------------------------
    def _match_query_dim(self, q) -> torch.Tensor:
        """Queries of the descriptor width (an int4 store of an odd width
        also takes them one narrower, as the reference) gain the store's
        zero columns, which never change a dot product; an l2 store's
        queries one narrower gain its ``-1`` column first. f32 on the first
        device."""
        q = torch.as_tensor(q, device=self.mesh.devices[0]).float()
        if q.ndim == 1:
            q = q[None]
        w = q.shape[-1]
        if self.l2 and w == self.dim - 1:
            q = torch.cat([q, q.new_full((q.shape[0], 1), -1.0)], 1)
            w += 1
        if w == self.dim or (self.int4 and w == self.dim - 1):
            q = torch.nn.functional.pad(q, (0, self.store_dim - w))
        if q.shape[-1] != self.store_dim:
            raise ValueError(f"queries have width {w}, the store {self.dim}")
        return q

    def _run_chunked(self, run, *per_query):
        """Pieces of at most ``query_chunk`` queries (utils/chunking.py, the
        policy of ``Index.search``)."""
        return run_chunked(run, self.query_chunk, *per_query)

    def _kw(self) -> dict:
        return {"use_pallas": self.use_pallas, "int4": self.int4}

    def place_subset(self, subset):
        """A subset filter's ``[1, N_pad]`` mask (a ``SubsetFilter`` or the
        mask itself) -> each local shard's ``[1, C]`` slice on its device,
        the ``mask=`` of this index's stages; reusable across queries. A
        mask of another padded size raises ``ValueError``."""
        if subset is None:
            return None
        mask = torch.as_tensor(getattr(subset, "mask", subset))
        if tuple(mask.shape) != (1, self.num_rows):
            raise ValueError(
                f"subset mask shape {tuple(mask.shape)} != [1, "
                f"{self.num_rows}] — the filter was built against a "
                f"different store (rebuild with make_subset)")
        c, first = self.rows_per_shard, self.mesh.first_shard
        return tuple(
            mask[:, (first + j) * c:(first + j + 1) * c].to(
                device=dev, dtype=torch.int8).contiguous()
            for j, dev in enumerate(self.mesh.devices))

    def _placed(self, mask):
        """``mask=`` of a stage: ``place_subset``'s slices, anything it
        takes, or None."""
        if mask is None or isinstance(mask, tuple):
            return mask
        return self.place_subset(mask)

    # ------------------------------------------------------------------
    def search(self, queries, k: "int | None" = None, mask=None):
        """``(scores [Q, k], dataset ids [Q, k])``, the single-device top-k
        over the whole store (over a subset's rows with ``mask``)."""
        masks = self._placed(mask)
        k = k or self.default_k
        q = self._match_query_dim(queries)
        return self._run_chunked(
            lambda qq: sharded_topk(self.mesh, self.shards,
                                    replicate(self.mesh, qq), self._ids,
                                    k, masks=masks, **self._kw()), q)

    def search_qe(self, queries, k: "int | None" = None, qe_n: int = 10,
                  alpha: float = 3.0, mask=None):
        """Search with alpha query expansion (two rounds of per-shard
        kernels, three gathers)."""
        masks = self._placed(mask)
        k = k or self.default_k
        q = self._match_query_dim(queries)
        return self._run_chunked(
            lambda qq: sharded_qe_topk(
                self.mesh, self.shards, replicate(self.mesh, qq),
                self._ids, k, qe_n, alpha, masks=masks, **self._kw()), q)

    def expand_queries(self, queries, qe_n: int = 10, alpha: float = 3.0,
                       include_query: bool = True, mask=None
                       ) -> torch.Tensor:
        """Alpha-QE expansion -> the expanded queries ``[Q, W]`` f32 (the
        store's width); ``include_query=False`` is αDBA's database-side
        weighting (``Index.augment_database(mesh=)``)."""
        masks = self._placed(mask)
        q = self._match_query_dim(queries)
        return self._run_chunked(
            lambda qq: sharded_expand(self.mesh, self.shards,
                                      replicate(self.mesh, qq), qe_n, alpha,
                                      masks=masks,
                                      include_query=include_query,
                                      **self._kw()), q)

    def _vote_matrices(self):
        if self._votes is None:
            v = build_vote_matrix(self.regional_geom, self.regional_geom)
            self._votes = [torch.as_tensor(v, device=d)
                           for d in self.mesh.devices]
        return self._votes

    def search_rerank(self, queries, query_regional, k: "int | None" = None,
                      depth: int = 100, fuse_weight: float = 1.0,
                      spatial_weight: float = 0.0, mask=None):
        """Regional re-ranking over the sharded regional store
        (:func:`sharded_rerank`); ``spatial_weight > 0`` adds the spatial
        vote and needs ``regional_geom``. ``depth`` is cut to the store's
        rows."""
        masks = self._placed(mask)
        if self.regional is None:
            raise ValueError("no regional store attached")
        if spatial_weight and self.regional_geom is None:
            raise ValueError("spatial_weight needs regional_geom (pass it "
                             "to ShardedIndex or use Index.to_sharded)")
        k = k or self.default_k
        depth = min(depth, self.num_rows)
        q = self._match_query_dim(queries)
        qreg = torch.as_tensor(query_regional,
                               device=self.mesh.devices[0]).float()
        votes = self._vote_matrices() if spatial_weight else None
        return self._run_chunked(
            lambda qq, rr: sharded_rerank(
                self.mesh, self.shards, replicate(self.mesh, qq),
                replicate(self.mesh, rr), self._ids, k, depth,
                fuse_weight=fuse_weight,
                spatial_weight=spatial_weight, votes=votes, masks=masks,
                **self._kw()), q, qreg)

    def search_refine(self, queries, k: "int | None" = None,
                      depth: int = 100, mask=None):
        """The exact refine over the one-region refine copy (the regional
        slot of an int4 index with ``refine_dtype``): the re-rank with the
        query, cut to the copy's width, as its one region and no global
        term, as the single-device stage."""
        if self.regional is None:
            raise ValueError("no refine store attached")
        q = self._match_query_dim(queries)
        width = self.shards[0].regional.shape[-1]
        return self.search_rerank(q, q[:, None, :width],
                                  k=k, depth=depth, fuse_weight=0.0,
                                  mask=mask)

    def search_diffusion(self, queries, k: "int | None" = None,
                         depth: int = 200, knn: int = 10, alpha: float = 0.99,
                         iters: int = 20, seeds: int = 10, mask=None):
        """Diffusion re-ranking (:func:`sharded_diffusion`), equal to
        ``Index.search`` with ``diffusion_enabled``; ``depth`` is cut to the
        store's rows."""
        masks = self._placed(mask)
        k = k or self.default_k
        depth = min(depth, self.num_rows)
        q = self._match_query_dim(queries)
        return self._run_chunked(
            lambda qq: sharded_diffusion(
                self.mesh, self.shards, replicate(self.mesh, qq), self._ids,
                k, depth, knn=knn, alpha=alpha, iters=iters, seeds=seeds,
                masks=masks, **self._kw()), q)

    def search_lw(self, queries, k: "int | None" = None, depth: int = 100,
                  mask=None):
        """Local-whitening re-scoring (:func:`sharded_lw`) over the sharded
        whitened store, equal to ``Index.search`` with ``lw_enabled``."""
        if self.lw_params is None:
            raise ValueError("no local-whitening view attached (fit one with "
                             "Index.fit_local_whitening, then to_sharded)")
        masks = self._placed(mask)
        k = k or self.default_k
        depth = min(depth, self.num_rows)
        q = self._match_query_dim(queries)
        return self._run_chunked(
            lambda qq: sharded_lw(self.mesh, self.shards,
                                  replicate(self.mesh, qq), self._ids, k,
                                  depth, self.lw_params, masks=masks,
                                  **self._kw()), q)

    def all_scores(self, queries) -> torch.Tensor:
        """The full ``[Q, N_pad]`` score matrix (padding -inf)."""
        q = self._match_query_dim(queries)
        return self._run_chunked(
            lambda qq: sharded_scores(self.mesh, self.shards,
                                      replicate(self.mesh, qq),
                                      int4=self.int4), q)

    def _local_rows(self, pos: torch.Tensor):
        """``(shard, indices into pos, its local rows)`` for each local
        shard holding some of the global positions ``pos``."""
        c, first = self.rows_per_shard, self.mesh.first_shard
        for j, sh in enumerate(self.shards):
            loc = pos - (first + j) * c
            sel = ((loc >= 0) & (loc < c)).nonzero()[:, 0]
            if len(sel):
                yield sh, sel, loc[sel].to(sh.x.device)

    def read_rows(self, pos: torch.Tensor, fields=_ROW_FIELDS) -> dict:
        """The stored rows at global positions ``pos [n]``, verbatim in the
        store's own dtype: ``fields`` (``Shard`` names: ``x``, ``scales``,
        ``regional``, ``regional_scales``; absent stores left out) -> ``[n,
        ...]`` tensors on the first device (``scales`` ``[n]``). With a
        process group it is collective (every process calls it with the
        same positions): each process reads the rows its own shards hold,
        and one ``all_gather`` of those rows' bytes, padded to the most any
        process holds, brings every process all of them. Rows are
        process-major, so every process knows each row's owner; the bytes
        cross as ``uint8``, so no value (a -0.0, an int8 row) passes
        through arithmetic. The contract is enforced: before any row moves,
        one ``all_gather`` of a checksum of ``pos`` (:meth:`_same_positions`)
        raises ``RuntimeError`` on every process when they passed different
        positions."""
        dev = self.mesh.devices[0]
        pos = pos.to(dev).long().reshape(-1)
        if self.mesh.group is not None:
            self._same_positions(pos)
        specs = {}           # field -> (row shape, dtype, elements a row)
        for f in fields:
            part = getattr(self.shards[0], f)
            if part is not None:
                tail = () if f == "scales" else tuple(part.shape[1:])
                specs[f] = (tail, part.dtype, int(np.prod(tail)))
        owner = pos // (self.rows_per_shard * self.mesh.num_local)
        mine = (pos if self.mesh.group is None
                else pos[owner == self.mesh.rank])
        out = {f: torch.empty((len(mine),) + tail, dtype=dt, device=dev)
               for f, (tail, dt, _) in specs.items()}
        held = 0
        for sh, sel, loc in self._local_rows(mine):
            held += len(sel)
            for f, t in out.items():
                part = getattr(sh, f)
                t[sel.to(dev)] = (part[0, loc] if f == "scales"
                                  else part[loc]).to(dev)
        if held != len(mine):
            raise ValueError(f"{len(mine) - held} of the positions lie past "
                             f"the store's {self.num_rows} rows")
        if self.mesh.group is None or not len(pos):
            return out
        import torch.distributed as dist
        world = self.mesh.world
        counts = torch.bincount(owner, minlength=world).tolist()
        packed = torch.cat([out[f].reshape(len(mine), e).view(torch.uint8)
                            for f, (_, _, e) in specs.items()], 1)
        width = max(counts)
        send = packed.new_zeros((width, packed.shape[1]))
        send[:len(mine)] = packed
        recv = [torch.empty_like(send) for _ in range(world)]
        dist.all_gather(recv, send, group=self.mesh.group)
        full = packed.new_empty((len(pos), packed.shape[1]))
        for r, n in enumerate(counts):
            if n:
                full[(owner == r).nonzero()[:, 0]] = recv[r][:n]
        res, col = {}, 0
        for f, (tail, dt, e) in specs.items():
            nb = e * out[f].element_size()
            res[f] = full[:, col:col + nb].contiguous().view(dt).reshape(
                (len(pos),) + tail)
            col += nb
        return res

    def _same_positions(self, pos: torch.Tensor) -> None:
        """Raise ``RuntimeError`` on every process unless all of the mesh's
        group passed the same positions ``pos [n]`` (int64, on the first
        device): one ``all_gather`` of three int64 sums (the count, the
        positions, and the positions weighted by their slot), so a
        different count, value or order is caught before a collective of
        another shape could hang."""
        import torch.distributed as dist
        slot = torch.arange(1, len(pos) + 1, device=pos.device)
        sig = torch.stack([pos.new_tensor(len(pos)), pos.sum(),
                           (pos * slot).sum()])
        sigs = [torch.empty_like(sig) for _ in range(self.mesh.world)]
        dist.all_gather(sigs, sig, group=self.mesh.group)
        if any(not torch.equal(t, sigs[0]) for t in sigs[1:]):
            raise RuntimeError(
                "ShardedIndex.read_rows is collective: the processes passed "
                "different positions (count, sum, weighted sum per process: "
                f"{[t.tolist() for t in sigs]})")

    def write_rows(self, pos: torch.Tensor, rows: dict) -> None:
        """Write ``rows`` (``Shard`` field -> ``[n, ...]`` values in the
        store's dtype, ``scales`` ``[n]``) at global positions ``pos [n]``,
        in place: the rows this process's shards hold go to their devices,
        the others are dropped (another process writes them)."""
        pos = pos.to(self.mesh.devices[0]).long().reshape(-1)
        for sh, sel, loc in self._local_rows(pos):
            for f, v in rows.items():
                part = getattr(sh, f)
                vals = v[sel.to(v.device)].to(part.device, part.dtype)
                if f == "scales":
                    part[0, loc] = vals
                else:
                    part[loc] = vals

    def rows_f32(self, pos: torch.Tensor) -> torch.Tensor:
        """Stored rows at global positions ``pos``, dequantized to f32 as
        every stage gathers them -> ``[n, W]`` on the first device; read by
        :meth:`read_rows` (collective with a process group)."""
        v = self.read_rows(pos, ("x", "scales"))
        n = v["x"].shape[0]
        return gather_rows_f32(v["x"], torch.arange(n, device=v["x"].device),
                               v.get("scales"), int4=self.int4)

    def full_ranking(self, queries) -> np.ndarray:
        """``[Q, num_valid]`` dataset ids best-first through the sharded
        scorer, the counterpart of ``Index.full_ranking`` for protocol
        evaluation. Padding (-inf) sorts last and is cut."""
        scores = self.all_scores(queries)
        order = torch.sort(scores, dim=1, descending=True, stable=True)[1]
        return self._ids[order][:, :self.num_valid].cpu().numpy()

    # ------------------------------------------------------------------
    def search_range(self, queries, thr, max_results: int = 1024,
                     mask=None):
        """Range search (:func:`sharded_range`): every row scoring at least
        ``thr`` (a float, or ``[Q]`` thresholds: ``Index.search_range``
        turns an l2 radius into them) -> ``(scores [Q, m], dataset ids [Q,
        m], counts [Q] int64)`` tensors, ``m = min(max_results, N_pad)`` as
        on one device; scores in the store's space (an l2 store's
        augmented inner products)."""
        masks = self._placed(mask)
        q = self._match_query_dim(queries)
        m = min(max_results, self.num_rows)
        thr = torch.as_tensor(thr, dtype=torch.float32,
                              device=q.device).expand(q.shape[0])
        return self._run_chunked(
            lambda qq, tt: sharded_range(
                self.mesh, self.shards, replicate(self.mesh, qq), self._ids,
                tt, m, masks=masks, dim=self.dim, **self._kw()), q, thr)

    def attach_ivfpq(self, view, nprobe: "int | None" = None,
                     depth: "int | None" = None) -> None:
        """Place an ``IVFPQView`` (``search/ivfpq.py``) for
        :meth:`search_ivfpq`: codes and positions cut along the buckets'
        capacity axis (padded with -1 slots to a multiple of the shard
        count, masked like any empty slot), the spill cut evenly (padded
        alike), each local shard's slice on its device; the centroids,
        codebook and rotation on every local device. ``to_sharded()``
        calls this when the index carries the view."""
        s = self.mesh.num_shards
        codes, bpos = view.codes, view.bucket_pos
        pad = (-codes.shape[1]) % s
        if pad:
            codes = torch.nn.functional.pad(codes, (0, 0, 0, pad))
            bpos = torch.nn.functional.pad(bpos, (0, pad), value=-1)
        sc, sp, scl = view.spill_codes, view.spill_pos, view.spill_cluster
        spad = (-sc.shape[0]) % s
        if spad:
            sc = torch.nn.functional.pad(sc, (0, 0, 0, spad))
            sp = torch.nn.functional.pad(sp, (0, spad), value=-1)
            scl = torch.nn.functional.pad(scl, (0, spad), value=-1)
        mw, sw = codes.shape[1] // s, sc.shape[0] // s
        first = self.mesh.first_shard
        slices = []
        for j, dev in enumerate(self.mesh.devices):
            g = first + j

            def cut(t, dim, w):
                return t.narrow(dim, g * w, w).to(dev).contiguous()
            slices.append(ShardIVFPQ(
                view.centroids.to(dev), cut(codes, 1, mw), cut(bpos, 1, mw),
                cut(sc, 0, sw), cut(sp, 0, sw), cut(scl, 0, sw),
                view.codebook.centroids.to(dev),
                None if view.rotation is None else view.rotation.to(dev)))
        self.ivfpq = slices
        self._ivfpq_nprobe = nprobe or view.nprobe
        self._ivfpq_depth = depth or view.depth

    def search_ivfpq(self, queries, k: "int | None" = None,
                     nprobe: "int | None" = None, depth: "int | None" = None,
                     qe_n: int = 0, qe_alpha: float = 3.0, mask=None):
        """The IVF-PQ cascade over the capacity-sharded codes
        (:func:`sharded_ivfpq`), equal to ``Index.search`` with
        ``ivfpq_nprobe`` armed but at near-ties of ADC scores at the depth
        boundary; ``qe_n > 0`` adds the composite's αQE. ``mask``: a subset
        filter, a raw ``[1, N_pad]`` mask, or ``place_subset``'s slices
        (joined again: the slots hold global positions)."""
        if self.ivfpq is None:
            raise ValueError("no IVF-PQ view attached (attach_ivfpq, or "
                             "to_sharded of an index with one)")
        k = k or self.default_k
        nprobe = min(nprobe or self._ivfpq_nprobe,
                     self.ivfpq[0].centroids.shape[0])
        depth = min(depth or self._ivfpq_depth, self.num_rows)
        if mask is not None:
            if isinstance(mask, tuple):
                mask = self.mesh.gather(list(mask))
            mask = torch.as_tensor(getattr(mask, "mask", mask))
            if tuple(mask.shape) != (1, self.num_rows):
                raise ValueError(
                    f"subset mask shape {tuple(mask.shape)} != [1, "
                    f"{self.num_rows}] — the filter was built against a "
                    f"different store (rebuild with make_subset)")
            mask = replicate(self.mesh, mask.to(torch.int8))
        q = self._match_query_dim(queries)
        return self._run_chunked(
            lambda qq: sharded_ivfpq(
                self.mesh, self.shards, self.ivfpq, replicate(self.mesh, qq),
                self._ids, k, depth, nprobe, int4=self.int4, qe_n=qe_n,
                qe_alpha=qe_alpha, mask=mask), q)
