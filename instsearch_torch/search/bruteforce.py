"""Brute-force cosine top-k, the plain scoring path (port of
``instsearch_tpu/search/bruteforce.py``: ``masked_scores`` and
``search_topk``), over float, int8 and packed-int4 stores.

This is the scoring oracle of the port. For a float store it is also the
basis of the fused kernel's plain version
(``kernels/topk_matmul.py::topk_matmul_reference``). For an int8 or int4
store it keeps the oracle's own semantics, an f32 query against the stored
integers times the row scales, where the K2/K3 kernels quantize the query.
"""
from __future__ import annotations

import torch

from ..ops.quantize import unpack_int4

# bytes of f64 temporaries (a chunk's widened rows and its [Q, chunk]
# scores) a range-count chunk may hold, and its most rows
_RANGE_BUDGET = 256 << 20
_RANGE_MAX_ROWS = 65_536


def masked_scores(descriptors: torch.Tensor, queries: torch.Tensor,
                  scales: "torch.Tensor | None" = None,
                  ids: "torch.Tensor | None" = None,
                  int4: bool = False,
                  mask: "torch.Tensor | None" = None) -> torch.Tensor:
    """[Q, N] f32 scores, the one scoring definition for float, int8 (with
    ``scales [1, N]``) and packed-int4 storage (``int4=True``: the store is
    ``[N, D // 2]`` nibble pairs, which its dtype cannot tell from int8).

    Float: both operands go to f32 before the product (a bf16 matmul would
    return bf16 scores, while bf16 x bf16 products are exact in f32), the
    query first cast to the store's dtype. int8/int4: ``(q_f32 .
    rows_f32^T) * scales``, in that order, as the reference. Padding rows
    (id -1) are masked to -inf when ``ids`` is given, and rows outside a
    subset when ``mask`` (``[1, N]`` int8, ``search/subset.py``) is."""
    if int4:
        scores = (queries.float() @ unpack_int4(descriptors).float().T
                  ) * scales
    elif descriptors.dtype == torch.int8:
        scores = (queries.float() @ descriptors.float().T) * scales
    elif descriptors.dtype in (torch.bfloat16, torch.float32):
        scores = (queries.to(descriptors.dtype).float()
                  @ descriptors.float().T)
    else:
        raise ValueError(f"store dtype {descriptors.dtype}: bfloat16, "
                         f"float32 or int8")
    if ids is not None:
        scores = scores.masked_fill(ids[None, :] < 0, float("-inf"))
    if mask is not None:
        scores = scores.masked_fill(mask.reshape(1, -1) <= 0, float("-inf"))
    return scores


def gather_rows_f32(descriptors: torch.Tensor, pos: torch.Tensor,
                    scales: "torch.Tensor | None" = None,
                    int4: bool = False) -> torch.Tensor:
    """Stored rows at padded positions ``pos [...]`` -> f32 ``[..., D]``,
    unpacked (int4) and dequantized (int8, int4): the one
    row-materialization definition of the search stages (port of
    ``instsearch_tpu/index.py::_gather_rows_f32``). ``pos`` must already be
    non-negative."""
    rows = descriptors[pos.long()]
    if int4:
        rows = unpack_int4(rows)
    rows = rows.float()
    if int4 or descriptors.dtype == torch.int8:
        rows = rows * scales.reshape(-1)[pos.long()][..., None]
    return rows


def select_topk(scores: torch.Tensor, k: int):
    """Top-k of [Q, N] scores -> ``(scores [Q, k], positions [Q, k] int32)``.
    A stable descending sort puts the lowest position first among ties, as
    ``lax.top_k`` does (``torch.topk`` promises no order). Slots scoring
    -inf, and slots past N when k > N, come back as ``(-inf, -1)``."""
    s, i = torch.sort(scores, dim=1, descending=True, stable=True)
    s, i = s[:, :k], i[:, :k].to(torch.int32)
    i = torch.where(s > float("-inf"), i, torch.full_like(i, -1))
    if s.shape[1] < k:
        pad = k - s.shape[1]
        s = torch.cat([s, s.new_full((s.shape[0], pad), float("-inf"))], 1)
        i = torch.cat([i, i.new_full((i.shape[0], pad), -1)], 1)
    return s, i


def search_topk(index: torch.Tensor, queries: torch.Tensor, k: int = 10,
                ids: "torch.Tensor | None" = None,
                scales: "torch.Tensor | None" = None, int4: bool = False,
                mask: "torch.Tensor | None" = None):
    """``index [N, D]``, ``queries [Q, D]`` -> ``(scores [Q, k], positions
    [Q, k])``; pass ``ids`` when the store carries padding rows (id -1),
    ``scales``/``int4`` for a quantized store, ``mask`` for a subset."""
    return select_topk(masked_scores(index, queries, scales=scales, ids=ids,
                                     int4=int4, mask=mask), k)


def range_count(descriptors: torch.Tensor, ids: torch.Tensor,
                queries: torch.Tensor, thr, scales=None, *,
                int4: bool = False, mask: "torch.Tensor | None" = None,
                dim: "int | None" = None) -> torch.Tensor:
    """The counting half of range search (the reference's
    ``_range_count_jit``): per query, the valid rows (id >= 0, in ``mask``
    when given) whose score reaches its threshold ``thr [Q]`` (f32) ->
    ``[Q]`` int64. The rows go through in chunks of at most
    ``_RANGE_MAX_ROWS`` whose f64 temporaries, the widened rows and the
    ``[Q, chunk]`` scores, stay under ``_RANGE_BUDGET`` bytes (never a
    ``[Q, N]`` matrix, nor the whole store widened). Each chunk is read
    over its first ``dim`` columns as every search stage reads it
    (dequantized to f32 for int8 and int4) and widened to f64 with the
    query: the products of f32 values are exact in f64 and the sums carry
    f64 rounding, so counts from different chunkings or shardings agree to
    f64 rounding, where an f32 sum's order would move a score at the
    threshold by an f32 ulp."""
    n = descriptors.shape[0]
    q = queries.float()
    if dim is not None:
        q = q[:, :dim]
    q = q.double()
    thr_b = thr.float().double()[:, None]
    chunk = max(1, min(n, _RANGE_MAX_ROWS,
                       _RANGE_BUDGET // (8 * (q.shape[0] + q.shape[1]))))
    counts = torch.zeros((q.shape[0],), dtype=torch.int64, device=q.device)
    for start in range(0, n, chunk):
        rows = descriptors[start:start + chunk]
        if int4:
            rows = unpack_int4(rows)
        rows = rows[:, :q.shape[1]]
        if scales is not None:
            rows = rows.float() * scales.reshape(-1)[start:start + chunk,
                                                     None]
        ok = ids[start:start + chunk] >= 0
        if mask is not None:
            ok = ok & (mask.reshape(-1)[start:start + chunk] > 0)
        hit = (q @ rows.double().T) >= thr_b
        counts += (hit & ok[None, :]).sum(dim=1)
    return counts
