"""Fused PQ-ADC top-k, K4 (port of ``instsearch_tpu/kernels/pq_scan.py::
pq_topk``): ``packed [N, M/2]`` int8 codes (``ops/pq.py::encode_pq``),
``q [B, D]`` float and a ``PQCodebook`` -> ``(scores [B, k] f32 sorted
descending, row positions [B, k] int32)``.

``pq_topk`` launches the hand-written CUDA kernel
(``instsearch_torch/csrc/pq_scan.cu``) for codes on a CUDA device and takes
its plain PyTorch version, ``pq_topk_reference``, for codes on the CPU. A
CUDA tensor the kernel cannot take raises; nothing falls back. Launches are
counted in ``pq_topk.launches``.

Semantics shared by the kernel, its plain version and the TPU kernel:
  * the lookup table is ``pq_lut(q, codebook)`` ``[B, M, 16]`` f32, rounded
    to bf16, as the TPU kernel feeds it to its one-hot matmul;
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
kernel reads a row's bytes as 4-byte words and needs G % 4 == 0 and k <=
K_MAX: ``search/pq_view.py::PQView`` pads its codes so once, when the view
is built (M = 12 from D = 96 becomes G = 8). The plain version takes any G
>= M/2 and any k. The TPU-only knobs of the reference (``tile_n``,
``variant``, ``interpret``) have no counterpart.
"""
from __future__ import annotations

import torch

from ..ops.pq import pq_lut
from ..search.bruteforce import select_topk
from .topk_matmul import (_check_k, _cuda_operands, _launch, _num_valid,
                          _plan, _valid_rows)

_PLAIN_ROWS = 1 << 20   # rows scored per piece by the plain version


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
    """``pq_lut`` rounded to bf16, held as f32 ``[B, 2 * groups, 16]``: the
    subspaces of the low nibbles at rows ``[0, M/2)``, of the high nibbles
    at ``[groups, groups + M/2)``, zeros for the padding bytes' nibbles."""
    lut = pq_lut(q, codebook).to(torch.bfloat16).float()
    half = codebook.m // 2
    if groups == half:
        return lut.contiguous()
    out = lut.new_zeros((lut.shape[0], 2 * groups, 16))
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


def pq_topk(packed: torch.Tensor, q: torch.Tensor, codebook, k: int = 10,
            num_valid: "int | None" = None,
            mask: "torch.Tensor | None" = None):
    """K4: fused ADC top-k over a PQ store; see the module docstring.
    ``mask``: optional ``[1, N]`` (or ``[N]``) int8 allow-list."""
    _check_pq_args(packed, q, codebook, k)
    if packed.device.type == "cpu":
        return pq_topk_reference(packed, q, codebook, k, num_valid, mask)
    n, groups = packed.shape
    m = 2 * groups                  # the subspaces the kernel walks
    b = q.shape[0]
    if groups % 4:
        raise ValueError(f"M={m}: the kernel reads a row's {groups} code "
                         f"bytes as 4-byte words and needs a multiple of 4 "
                         f"(PQView pads its codes so)")
    _check_k(k)
    for name, t in (("q", q), ("codebook", codebook.centroids)):
        if t.device != packed.device:
            raise ValueError(f"{name} on {t.device}, codes on "
                             f"{packed.device}")
    lut = _lut(q, codebook, groups)
    mask = _cuda_operands(packed, mask, q=lut)
    nv = _num_valid(n, num_valid)

    from . import _build
    lib = _build.load()
    qb, rows, slices = _plan(lambda w: lib.isf_pq_pass1_smem(w, m, k),
                             n, m, b, k, packed.device)

    def launch(out_s, out_i, cand_s, cand_i, _, stream):
        return lib.isf_pq_topk(
            packed.data_ptr(), lut.data_ptr(),
            mask.data_ptr() if mask is not None else None, out_s, out_i,
            cand_s, cand_i, n, m, b, k, nv, qb, rows, slices, stream)

    return _launch(pq_topk, launch, packed, b, k, slices)


# kernel launches; reset by whoever counts them
pq_topk.launches = 0
