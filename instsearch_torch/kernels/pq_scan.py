"""Fused PQ-ADC top-k, K4 (port of ``instsearch_tpu/kernels/pq_scan.py::
pq_topk``): ``packed [N, M/2]`` int8 codes (``ops/pq.py::encode_pq``),
``q [B, D]`` float and a ``PQCodebook`` -> ``(scores [B, k] f32 sorted
descending, row positions [B, k] int32)``.

``pq_topk`` launches the hand-written CUDA kernel
(``instsearch_torch/csrc/pq_scan.cu``) for codes on a CUDA device and takes
its plain PyTorch version, ``pq_topk_reference``, for codes on the CPU. A
CUDA tensor the kernel cannot take raises; nothing falls back. Launches are
counted in ``pq_topk.launches`` (with a subset ``mask``, in
``pq_topk.launches_subset`` too). On the card the lookup table is built by
the first kernel of the launch sequence; ``pq_table`` runs that kernel
alone (counted in ``pq_table.launches``), so that it can be held to its
plain version, ``_lut``.

Semantics shared by the kernel, its plain version and the TPU kernel:
  * the lookup table ``[B, M, 16]`` is ``q[b]_m . C[m, j]`` rounded to
    bf16, as the TPU kernel feeds ``pq_lut(q, codebook)`` to its one-hot
    matmul. Kernel and plain version fix the dot product's order
    (``_lut``): ``q[b, m ds] C[m, j, 0]``, then ``+ q[b, m ds + t] C[m, j,
    t]`` for t = 1 ... ds - 1, each product and each sum one f32 operation
    rounded to nearest, then one rounding to bf16, to nearest-even. The
    TPU's einsum sums in an order of its own, so an entry may differ from
    the reference's by one bf16 step where an f32 sum lies within an f32
    ulp of a rounding midpoint;
  * the code of subspace m < M/2 is the low nibble of byte m, ``byte - 16 *
    (byte >> 4)``; of subspace m >= M/2 the high nibble of byte m - M/2,
    ``(byte >> 4) + 8``;
  * a score is ``s_lo + s_hi``: ``s_lo`` the f32 sum of ``lut[b, m,
    code_m]`` over m < M/2 in ascending m, from 0, ``s_hi`` the same over
    m >= M/2. The TPU's matrix unit sums in an unspecified order; kernel and
    plain version fix this one, so they agree bit for bit;
  * rows at or past ``num_valid``, and rows whose ``mask`` entry is not > 0,
    are never returned; ties go to the lowest row position; slots beyond the
    count of valid rows come back as ``(-inf, -1)``.

``packed`` may carry G > M/2 bytes a row: bytes past M/2 are padding and
never reach a score (their subspaces' table rows are zeros, and adding +0.0
changes no sum), so a score equals the unpadded one bit for bit. The CUDA
kernel reads a row's bytes as 4-byte words and needs G % 4 == 0, codes
16-byte aligned and k <= K_MAX: ``search/pq_view.py::PQView`` pads its
codes so once, when the view is built (M = 12 from D = 96 becomes G = 8).
The plain version takes any G >= M/2 and any k. The TPU-only knobs of the
reference (``tile_n``, ``variant``, ``interpret``) have no counterpart.
"""
from __future__ import annotations

import functools

import torch

from ..search.bruteforce import select_topk
from .topk_matmul import (_SMEM_LIMIT, _check_k, _cuda_operands, _launch,
                          _num_valid, _plan, _valid_rows)

_PLAIN_ROWS = 1 << 20   # rows scored per piece by the plain version
_QB_PQ = (1, 16)        # query blocks K4's pass 1 is built for
_CODES = 16             # codes a subspace


def _check_pq_args(packed: torch.Tensor, q: torch.Tensor, codebook,
                   k: int) -> None:
    if packed.dim() != 2 or packed.dtype != torch.int8 or q.dim() != 2:
        raise ValueError(f"packed must be int8 [N, G >= M/2] and q [B, D]; "
                         f"got {packed.dtype} {tuple(packed.shape)} and "
                         f"{tuple(q.shape)}")
    groups = packed.shape[1]
    if 2 * groups < codebook.m:          # the reference's message
        raise ValueError(f"packed groups {groups} need m={2 * groups}, "
                         f"codebook has m={codebook.m}")
    if q.shape[1] != codebook.dim:
        raise ValueError(f"query dim {q.shape[1]} != codebook dim "
                         f"{codebook.dim}")
    if k < 1:
        raise ValueError(f"k={k} < 1")


def _lut(q: torch.Tensor, codebook, groups: int) -> torch.Tensor:
    """The table of the module docstring, held as f32 ``[B, 2 * groups,
    16]``: the subspaces of the low nibbles at rows ``[0, M/2)``, of the
    high nibbles at ``[groups, groups + M/2)``, zeros for the padding
    bytes' nibbles. Each dot product in the fixed order: one f32 product,
    then one f32 addition of each next product (separate operations, no
    fused multiply-add), then one rounding to bf16."""
    b, m, ds = q.shape[0], codebook.m, codebook.ds
    qs = q.float().reshape(b, m, 1, ds)
    cent = codebook.centroids.float()                       # [m, 16, ds]
    acc = qs[..., 0] * cent[..., 0]
    for t in range(1, ds):
        acc = acc + qs[..., t] * cent[..., t]
    lut = acc.to(torch.bfloat16).float()
    half = m // 2
    if groups == half:
        return lut.contiguous()
    out = lut.new_zeros((b, 2 * groups, _CODES))
    out[:, :half] = lut[:, :half]
    out[:, groups:groups + half] = lut[:, half:]
    return out


def _adc_scores(packed: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """``[B, rows]`` scores of ``packed [rows, G]`` against ``lut [B, 2G,
    16]`` in the kernel's order: each half summed over ascending m from 0,
    then the two halves added."""
    groups = packed.shape[1]
    p = packed.to(torch.int32)
    hi = p >> 4
    lo = (p - 16 * hi).long()
    hi = (hi + 8).long()
    b, rows = lut.shape[0], packed.shape[0]
    s_lo = torch.zeros((b, rows), dtype=torch.float32, device=packed.device)
    s_hi = torch.zeros_like(s_lo)
    for j in range(groups):
        s_lo = s_lo + lut[:, j][:, lo[:, j]]
    for j in range(groups):
        s_hi = s_hi + lut[:, groups + j][:, hi[:, j]]
    return s_lo + s_hi


def pq_topk_reference(packed: torch.Tensor, q: torch.Tensor, codebook,
                      k: int = 10, num_valid: "int | None" = None,
                      mask: "torch.Tensor | None" = None):
    """K4's plain version: the scores of the module docstring in pieces of
    ``_PLAIN_ROWS`` rows, each piece's stable top-k, then the stable top-k
    of the pieces' candidates (earlier pieces first, so ties still go to
    the lowest position)."""
    _check_pq_args(packed, q, codebook, k)
    n = packed.shape[0]
    lut = _lut(q, codebook, packed.shape[1])
    valid = _valid_rows(n, num_valid, mask, packed.device)
    cand_s, cand_i = [], []
    for s0 in range(0, n, _PLAIN_ROWS):
        scores = _adc_scores(packed[s0:s0 + _PLAIN_ROWS], lut)
        scores = scores.masked_fill(~valid[s0:s0 + _PLAIN_ROWS],
                                    float("-inf"))
        s, i = select_topk(scores, k)
        cand_s.append(s)
        cand_i.append(torch.where(i >= 0, i + s0, i))
    if len(cand_s) == 1:
        return cand_s[0], cand_i[0]
    s, slot = select_topk(torch.cat(cand_s, dim=1), k)
    i = torch.cat(cand_i, dim=1).gather(1, slot.clamp(min=0).long())
    return s, torch.where(slot >= 0, i, torch.full_like(i, -1))


def _check_table_args(q: torch.Tensor, codebook, groups: int) -> None:
    if q.dim() != 2 or q.shape[1] != codebook.dim:
        raise ValueError(f"q must be [B, {codebook.dim}]; got "
                         f"{tuple(q.shape)}")
    if 2 * groups < codebook.m:
        raise ValueError(f"{groups} groups cannot hold m={codebook.m}")


def pq_table(q: torch.Tensor, codebook, groups: "int | None" = None):
    """The first kernel of K4's launch sequence on its own: ``q [B, D]`` ->
    the table ``[B, 2 * groups, 16]`` f32 of ``_lut`` (``groups`` defaults
    to M/2), bit for bit. A CPU tensor takes ``_lut``. Counts its launches
    in ``.launches``."""
    groups = codebook.m // 2 if groups is None else int(groups)
    _check_table_args(q, codebook, groups)
    if q.device.type == "cpu":
        return _lut(q, codebook, groups)
    qf, cent = _table_operands(q, codebook)
    b, d = qf.shape
    out = torch.empty((b, 2 * groups, _CODES), dtype=torch.float32,
                      device=qf.device)
    from . import _build
    lib = _build.load()
    with torch.cuda.device(qf.device):
        err = lib.isf_pq_table(
            qf.data_ptr(), cent.data_ptr(), out.data_ptr(), b, d, codebook.m,
            groups, torch.cuda.current_stream(qf.device).cuda_stream)
    if err:
        raise RuntimeError(f"pq_table kernel launch failed: CUDA error {err} "
                           f"(B={b}, D={d}, M={codebook.m})")
    pq_table.launches += 1
    return out


def _table_operands(q: torch.Tensor, codebook):
    """The query and centroids as the table kernel reads them: contiguous
    f32 on one CUDA device."""
    cent = codebook.centroids
    if cent.device != q.device:
        raise ValueError(f"codebook on {cent.device}, q on {q.device}")
    return tuple(t if t.dtype == torch.float32 and t.is_contiguous()
                 else t.to(torch.float32).contiguous() for t in (q, cent))


@functools.lru_cache(maxsize=256)
def _pq_plan(n: int, groups: int, b: int, k: int, device):
    """``_plan`` for K4's pass 1, kept per shape: at B=1 the wrapper's host
    time is a large part of a call."""
    from . import _build
    lib = _build.load()
    return _plan(lambda w: lib.isf_pq_pass1_smem(w, groups, k), n,
                 2 * groups, b, k, device, _QB_PQ, _SMEM_LIMIT)


def pq_topk(packed: torch.Tensor, q: torch.Tensor, codebook, k: int = 10,
            num_valid: "int | None" = None, *,
            mask: "torch.Tensor | None" = None):
    """K4: fused ADC top-k over a PQ store; see the module docstring.
    ``mask``: optional ``[1, N]`` (or ``[N]``) int8 allow-list."""
    _check_pq_args(packed, q, codebook, k)
    if packed.device.type == "cpu":
        return pq_topk_reference(packed, q, codebook, k, num_valid, mask)
    n, groups = packed.shape
    b = q.shape[0]
    if groups % 4:
        raise ValueError(f"M={2 * groups}: the kernel reads a row's {groups} "
                         f"code bytes as 4-byte words and needs a multiple "
                         f"of 4 (PQView pads its codes so)")
    _check_k(k)
    if q.device != packed.device:
        raise ValueError(f"q on {q.device}, codes on {packed.device}")
    qf, cent = _table_operands(q, codebook)
    mask = _cuda_operands(packed, mask, q=qf)
    nv = _num_valid(n, num_valid)
    qb, rows, slices = _pq_plan(n, groups, b, k, packed.device)
    from . import _build
    lib = _build.load()
    d, m = qf.shape[1], codebook.m

    def launch(out_s, out_i, cand_s, cand_i, table, stream):
        return lib.isf_pq_topk(
            packed.data_ptr(), qf.data_ptr(), cent.data_ptr(), table,
            mask.data_ptr() if mask is not None else None, out_s, out_i,
            cand_s, cand_i, n, groups, b, d, m, k, nv, qb, rows, slices,
            stream)

    # the table [b, 2 groups, 16] f32 goes into scratch behind the
    # candidates
    return _launch(pq_topk, launch, packed, b, k, slices,
                   scratch=4 * b * 2 * groups * _CODES,
                   masked=mask is not None)


# kernel launches, and those with a subset mask; reset by whoever counts
# them
pq_topk.launches = pq_topk.launches_subset = 0
pq_table.launches = 0
