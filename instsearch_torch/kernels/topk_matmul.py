"""Fused brute-force top-k (port of ``instsearch_tpu/kernels/topk_matmul.py::
topk_matmul``): ``x [N, D]`` rows, ``q [B, D]`` queries ->
``(scores [B, k] f32 sorted descending, row positions [B, k] int32)``.

``topk_matmul`` launches the hand-written CUDA kernel
(``instsearch_torch/csrc/topk_matmul.cu``) for tensors on a CUDA device and
takes the plain PyTorch version, ``topk_matmul_reference``, for tensors on
the CPU. A CUDA tensor the kernel cannot take raises; nothing falls back.

Semantics shared by both, and by the TPU kernel:
  * the query is cast to the store's dtype first, products accumulate in f32;
  * rows at or past ``num_valid``, and rows whose ``mask`` entry is not > 0,
    are never returned;
  * ties go to the lowest row position first;
  * slots beyond the count of valid rows come back as ``(-inf, -1)``.
"""
from __future__ import annotations

import torch

from ..search.bruteforce import masked_scores, select_topk

K_MAX = 1024            # longest list the kernel keeps (shared memory bound)
_CHUNK = 256            # rows per selection round; kChunk in the .cu file
_SMEM_BUDGET = 200 * 1024   # under the 227 KB a Hopper block may use
_QB_MAX = 8             # widest query block the kernel is built for
_CTAS_PER_SM = 2        # pass-1 blocks to aim for, per multiprocessor
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _check_args(x: torch.Tensor, q: torch.Tensor, k: int) -> None:
    if x.dim() != 2 or q.dim() != 2 or q.shape[1] != x.shape[1]:
        raise ValueError(f"x must be [N, D] and q [B, D]; got "
                         f"{tuple(x.shape)} and {tuple(q.shape)}")
    if x.dtype in (torch.int8, torch.uint8):
        raise NotImplementedError(
            "int8/int4 stores need the K2/K3 kernels, which are not ported "
            "yet (ROADMAP Queue 2)")
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"store dtype {x.dtype}: bfloat16 or float32")
    if not 1 <= k <= K_MAX:
        raise ValueError(f"k={k} outside [1, {K_MAX}]")


def topk_matmul_reference(x: torch.Tensor, q: torch.Tensor, k: int = 10,
                          num_valid: "int | None" = None,
                          mask: "torch.Tensor | None" = None):
    """The plain version: the scoring oracle's full f32 score matrix
    (``search.bruteforce``), invalid rows masked, stable top-k."""
    _check_args(x, q, k)
    n = x.shape[0]
    nv = n if num_valid is None else int(num_valid)
    valid = torch.arange(n, device=x.device) < nv
    if mask is not None:
        valid = valid & (mask.reshape(-1).to(torch.int32) > 0)
    scores = masked_scores(x, q).masked_fill(~valid, float("-inf"))
    return select_topk(scores, k)


def check_against_plain(x: torch.Tensor, q: torch.Tensor,
                        scores: torch.Tensor, pos: torch.Tensor,
                        ref_scores: torch.Tensor, ref_pos: torch.Tensor,
                        tol: float) -> float:
    """Hold a top-k answer ``(scores, pos)`` for ``x``, ``q`` to the plain
    version's ``(ref_scores, ref_pos)`` on the same inputs. Raises
    ``AssertionError`` at the first breach; returns the largest score
    difference over filled slots.

    * the same slots are empty, and an empty slot is exactly ``(-inf, -1)``;
    * scores agree to ``tol``;
    * the answer is in its own ``(score desc, position asc)`` order, with no
      position twice in a row;
    * a slot may hold another position than the plain version's only where
      the two rows are not copies of each other and the plain version's
      scores of them differ by less than ``tol``: two sums in different
      orders can flip such a near-tie. Copies score the same in any order,
      so among them the lowest position must come first.
    """
    def fail(msg):
        raise AssertionError(f"top-k disagrees with the plain version: {msg}")

    filled = pos >= 0
    if not torch.equal(filled, ref_pos >= 0):
        fail("different slots are empty")
    if not bool(torch.isneginf(scores[~filled]).all()):
        fail("an empty slot has a finite score")
    if not bool(torch.isfinite(scores[filled]).all()):
        fail("a filled slot has a non-finite score")
    err = ((scores[filled] - ref_scores[filled]).abs().max().item()
           if bool(filled.any()) else 0.0)
    if err > tol:
        fail(f"scores differ by {err} > {tol}")

    both = filled[:, :-1] & filled[:, 1:]
    s0, s1 = scores[:, :-1], scores[:, 1:]
    in_order = (s0 > s1) | ((s0 == s1) & (pos[:, :-1] < pos[:, 1:]))
    if not bool(in_order[both].all()):
        fail("not in (score desc, position asc) order")
    srt = torch.sort(torch.where(filled, pos, -1 - torch.arange(
        pos.shape[1], device=pos.device)), dim=1).values
    if bool((srt[:, 1:] == srt[:, :-1]).any()):
        fail("a position appears twice in one row")

    rows, slots = torch.nonzero(pos != ref_pos, as_tuple=True)
    if rows.numel():
        a, b = pos[rows, slots].long(), ref_pos[rows, slots].long()
        xa, xb = x[a], x[b]
        if bool((xa == xb).all(dim=1).any()):
            fail("copies of one row came out of position order")
        qq = q[rows].to(x.dtype).float()
        gap = ((xa.float() * qq).sum(1) - (xb.float() * qq).sum(1)).abs()
        if gap.max().item() >= tol:
            fail(f"positions differ beyond a near-tie (score gap "
                 f"{gap.max().item()})")
    return err


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _plan(lib, n: int, d: int, b: int, k: int, device) -> tuple[int, int, int]:
    """(query block, rows per slice, slices) for one launch."""
    qb = 1
    while qb < min(b, _QB_MAX):
        qb *= 2
    while qb > 1 and lib.isf_topk_pass1_smem(qb, d, k) > _SMEM_BUDGET:
        qb //= 2
    if lib.isf_topk_pass1_smem(qb, d, k) > _SMEM_BUDGET:
        raise ValueError(f"D={d}, k={k}: the query row and top-k list do not "
                         f"fit one block's shared memory")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    target = _cdiv(_CTAS_PER_SM * sms, _cdiv(b, qb))
    slices = max(1, min(_cdiv(n, _CHUNK), target, 65535))
    rows = _cdiv(_cdiv(n, slices), _CHUNK) * _CHUNK
    return qb, rows, _cdiv(n, rows)


def topk_matmul(x: torch.Tensor, q: torch.Tensor, k: int = 10,
                num_valid: "int | None" = None,
                mask: "torch.Tensor | None" = None):
    """Fused top-k over ``x`` for queries ``q``; see the module docstring.
    ``mask``: optional ``[1, N]`` (or ``[N]``) int8 allow-list."""
    _check_args(x, q, k)
    if x.device.type == "cpu":
        return topk_matmul_reference(x, q, k, num_valid, mask)
    if x.device.type != "cuda":
        raise ValueError(f"store on {x.device}: the kernel takes CUDA tensors")
    for name, t in (("x", x), ("q", q), ("mask", mask)):
        if t is None:
            continue
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, store on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    n, d = x.shape
    b = q.shape[0]
    if d % 8:
        raise ValueError(f"D={d}: the kernel reads rows as 16-byte vectors "
                         f"and needs D % 8 == 0")
    q = q.to(x.dtype)
    for name, t in (("x", x), ("q", q)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")
    if mask is not None:
        if mask.numel() != n:
            raise ValueError(f"mask has {mask.numel()} entries for {n} rows")
        mask = mask.reshape(-1).to(torch.int8)
    nv = n if num_valid is None else max(0, min(int(num_valid), n))

    from . import _build
    lib = _build.load()
    qb, rows, slices = _plan(lib, n, d, b, k, x.device)
    # the scratch may be freed while the kernel still runs: the caching
    # allocator hands it out again only to work queued behind it on this
    # stream
    out_s = torch.empty((b, k), dtype=torch.float32, device=x.device)
    out_i = torch.empty((b, k), dtype=torch.int32, device=x.device)
    cand_s = torch.empty((b * slices * k,), dtype=torch.float32,
                         device=x.device)
    cand_i = torch.empty((b * slices * k,), dtype=torch.int32,
                         device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.isf_topk_matmul(
            x.data_ptr(), q.data_ptr(),
            mask.data_ptr() if mask is not None else None,
            out_s.data_ptr(), out_i.data_ptr(), cand_s.data_ptr(),
            cand_i.data_ptr(), n, d, b, k, nv, _DTYPE_CODE[x.dtype], qb,
            rows, slices, stream)
    if err:
        raise RuntimeError(f"topk_matmul kernel launch failed: CUDA error "
                           f"{err} (N={n}, D={d}, B={b}, k={k}, qb={qb})")
    topk_matmul.launches += 1
    return out_s, out_i


topk_matmul.launches = 0    # kernel launches; reset by whoever counts them
