"""Fused brute-force top-k (port of ``instsearch_tpu/kernels/topk_matmul.py``)
over the three row stores:

  * ``topk_matmul`` (K1): ``x [N, D]`` bf16/f32 rows, ``q [B, D]``;
  * ``topk_matmul_int8`` (K2): ``x [N, D]`` int8 rows with f32 row
    ``scales [1, N]``;
  * ``topk_matmul_int4`` (K3): ``x [N, D/2]`` packed nibble pairs
    (``ops/quantize.py::quantize_rows_int4``) with f32 row ``scales``;

each -> ``(scores [B, k] f32 sorted descending, row positions [B, k]
int32)``.

Each wrapper launches its hand-written CUDA kernel
(``instsearch_torch/csrc/topk_matmul.cu``, ``topk_matmul_int.cu``; bf16,
int8 and int4 stores score on the tensor-core pass 1 of ``topk_mma.cuh``)
for tensors on a CUDA device and takes its plain PyTorch version
(``*_reference``) for tensors on the CPU. A CUDA tensor the kernel cannot
take raises; nothing falls back. Each counts its kernel launches in
``.launches``, and those given a subset ``mask`` in ``.launches_subset``
too.

Semantics shared by the kernels, their plain versions and the TPU kernels:
  * K1: the query is cast to the store's dtype first, products accumulate
    in f32;
  * K2/K3: the query is quantized per row to int8
    (``ops/quantize.py::quantize_rows``; on the card by the first kernel of
    the launch sequence, ``quantize_query``), the product is an exact int32
    sum, and a score is ``float(acc) * q_scale * x_scale``, in that order,
    so kernel and plain version agree bit for bit;
  * rows at or past ``num_valid``, and rows whose ``mask`` entry is not > 0,
    are never returned;
  * ties go to the lowest row position first;
  * slots beyond the count of valid rows come back as ``(-inf, -1)``.
"""
from __future__ import annotations

import functools

import torch

from ..ops.quantize import quantize_rows, unpack_int4
from ..search.bruteforce import masked_scores, select_topk

K_MAX = 1024            # longest list the kernel keeps (shared memory bound)
_CHUNK = 256            # rows per selection round; kChunk in topk_common.cuh
_SMEM_BUDGET = 200 * 1024   # the FMA pass 1's, under the 227 KB of a block
_SMEM_LIMIT = 232_448   # the 227 KB a Hopper block may use
_QB_FMA = (1, 8)        # query blocks the f32 FMA pass 1 is built for
_QB_MMA = (8, 128)      # and the tensor-core pass 1 (bf16, int8, int4)
_CTAS_PER_SM = 2        # pass-1 blocks to aim for, per multiprocessor
_DTYPES = (torch.float32, torch.bfloat16)
_PLAIN_ROWS = 1 << 16   # rows per f64 product in the integer plain versions


def _check_k(k: int) -> None:
    if not 1 <= k <= K_MAX:
        raise ValueError(f"k={k} outside [1, {K_MAX}]")


def _check_args(x: torch.Tensor, q: torch.Tensor, k: int) -> None:
    if x.dim() != 2 or q.dim() != 2 or q.shape[1] != x.shape[1]:
        raise ValueError(f"x must be [N, D] and q [B, D]; got "
                         f"{tuple(x.shape)} and {tuple(q.shape)}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"store dtype {x.dtype}: bfloat16 or float32 (int8 "
                         f"and int4 rows go to topk_matmul_int8 / "
                         f"topk_matmul_int4)")
    _check_k(k)


def _check_int_args(x: torch.Tensor, scales: torch.Tensor, q: torch.Tensor,
                    k: int, int4: bool) -> None:
    if x.dim() != 2 or q.dim() != 2 or x.dtype != torch.int8:
        raise ValueError(f"x must be int8 [N, {'D/2' if int4 else 'D'}] and "
                         f"q [B, D]; got {x.dtype} {tuple(x.shape)} and "
                         f"{tuple(q.shape)}")
    width = 2 * x.shape[1] if int4 else x.shape[1]
    if q.shape[1] != width:
        what = (f"2 * packed dim {x.shape[1]}" if int4 else
                f"store dim {width}")
        raise ValueError(f"query dim {q.shape[1]} != {what}")
    if scales.numel() != x.shape[0]:
        raise ValueError(f"{scales.numel()} row scales for {x.shape[0]} rows")
    _check_k(k)


def _valid_rows(n: int, num_valid, mask, device) -> torch.Tensor:
    nv = n if num_valid is None else int(num_valid)
    valid = torch.arange(n, device=device) < nv
    if mask is not None:
        valid = valid & (mask.reshape(-1).to(torch.int32) > 0)
    return valid


def topk_matmul_reference(x: torch.Tensor, q: torch.Tensor, k: int = 10,
                          num_valid: "int | None" = None,
                          mask: "torch.Tensor | None" = None):
    """K1's plain version: the scoring oracle's full f32 score matrix
    (``search.bruteforce``), invalid rows masked, stable top-k."""
    _check_args(x, q, k)
    valid = _valid_rows(x.shape[0], num_valid, mask, x.device)
    scores = masked_scores(x, q).masked_fill(~valid, float("-inf"))
    return select_topk(scores, k)


def _int_scores(x: torch.Tensor, scales: torch.Tensor, q: torch.Tensor,
                int4: bool) -> torch.Tensor:
    """[B, N] f32 scores of the K2/K3 definition. The int32 sums come from
    an f64 product of the integer operands, which is exact (|sum| < 2^53)
    on any device; CUDA has no integer matmul. Rows go in pieces of
    _PLAIN_ROWS so the f64 copy stays small."""
    qr = quantize_rows(q)
    q64 = qr.values.double()
    acc = []
    for s in range(0, x.shape[0], _PLAIN_ROWS):
        rows = x[s:s + _PLAIN_ROWS]
        rows = unpack_int4(rows) if int4 else rows
        acc.append((q64 @ rows.double().T).to(torch.int32))
    acc = torch.cat(acc, dim=1)
    return acc.float() * qr.scales.reshape(-1, 1) * scales.reshape(1, -1)


def _int_reference(x, scales, q, k, num_valid, mask, int4: bool):
    _check_int_args(x, scales, q, k, int4)
    valid = _valid_rows(x.shape[0], num_valid, mask, x.device)
    scores = _int_scores(x, scales.float(), q.float(), int4)
    return select_topk(scores.masked_fill(~valid, float("-inf")), k)


def topk_matmul_int8_reference(x_int8: torch.Tensor, scales: torch.Tensor,
                               q: torch.Tensor, k: int = 10,
                               num_valid: "int | None" = None,
                               mask: "torch.Tensor | None" = None):
    """K2's plain version: exact int32 sums of the int8-quantized query
    against the rows, scaled, invalid rows masked, stable top-k."""
    return _int_reference(x_int8, scales, q, k, num_valid, mask, int4=False)


def topk_matmul_int4_reference(x_packed: torch.Tensor, scales: torch.Tensor,
                               q: torch.Tensor, k: int = 10,
                               num_valid: "int | None" = None,
                               mask: "torch.Tensor | None" = None):
    """K3's plain version: as K2's, over the unpacked int4 rows."""
    return _int_reference(x_packed, scales, q, k, num_valid, mask, int4=True)


def check_exact(scores: torch.Tensor, pos: torch.Tensor,
                ref_scores: torch.Tensor, ref_pos: torch.Tensor) -> float:
    """The rule K2 and K3 are held to against their plain versions: equal
    bit for bit, since their sums are exact integers. Raises
    ``AssertionError`` naming the first differing slot; returns 0.0, the
    largest score difference."""
    for name, a, b in (("positions", pos, ref_pos),
                       ("scores", scores, ref_scores)):
        if a.shape != b.shape or not torch.equal(a, b):
            bad = (torch.nonzero(a != b)[:1].tolist()
                   if a.shape == b.shape else "shape")
            raise AssertionError(f"top-k differs from the plain version: "
                                 f"{name} at {bad}")
    return 0.0


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


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _plan(smem, n: int, d: int, b: int, k: int, device,
          qbs: tuple[int, int] = _QB_FMA,
          budget: int = _SMEM_BUDGET) -> tuple[int, int, int]:
    """(query block, rows per slice, slices) for one launch; ``smem(qb)`` is
    the kernel's pass-1 shared memory for a query block of qb rows, a power
    of two in ``qbs`` (narrowest, widest) as wide as b allows and ``budget``
    holds."""
    lo, hi = qbs
    qb = lo
    while qb < min(b, hi):
        qb *= 2
    while qb > lo and smem(qb) > budget:
        qb //= 2
    if smem(qb) > budget:
        raise ValueError(f"D={d}, k={k}: the query row and top-k list do not "
                         f"fit one block's shared memory")
    sms = _sm_count(device)
    # as many blocks as run at once: a slice fewer is a merge and a list's
    # inserts fewer
    per_sm = max(1, min(_CTAS_PER_SM, _SMEM_LIMIT // (smem(qb) + 1024)))
    target = _cdiv(per_sm * sms, _cdiv(b, qb))
    slices = max(1, min(_cdiv(n, _CHUNK), target, 65535))
    rows = _cdiv(_cdiv(n, slices), _CHUNK) * _CHUNK
    return qb, rows, _cdiv(n, rows)


def _cuda_operands(x: torch.Tensor, mask, **tensors) -> "torch.Tensor | None":
    """Raise unless every operand lies on x's CUDA device and is contiguous,
    and the ones read as 16-byte vectors (rows, query) are 16-byte aligned;
    returns the mask as int8 [N]."""
    if x.device.type != "cuda":
        raise ValueError(f"store on {x.device}: the kernel takes CUDA tensors")
    for name, t in (("x", x), ("mask", mask), *tensors.items()):
        if t is None:
            continue
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, store on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name in ("x", "q") and t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")
    if mask is None:
        return None
    if mask.numel() != x.shape[0]:
        raise ValueError(f"mask has {mask.numel()} entries for "
                         f"{x.shape[0]} rows")
    return mask.reshape(-1).to(torch.int8)


def _launch(fn, launch, x, b: int, k: int, slices: int, scratch: int = 0,
            masked: bool = False):
    """Allocate the outputs, and the candidates (f32 scores, int32
    positions, ``b * slices * k`` each) and ``scratch`` more bytes in one
    buffer; ``launch(out_s, out_i, cand_s, cand_i, scratch, stream)`` (data
    pointers, each scratch part 16-byte aligned) on the current stream,
    raise on its CUDA error code, count the launch on ``fn`` (and, with a
    subset ``mask``, on ``fn.launches_subset`` too)."""
    # the scratch may be freed while the kernel still runs: the caching
    # allocator hands it out again only to work queued behind it on this
    # stream
    out_s = torch.empty((b, k), dtype=torch.float32, device=x.device)
    out_i = torch.empty((b, k), dtype=torch.int32, device=x.device)
    part = _align16(4 * b * slices * k)
    buf = torch.empty((2 * part + scratch,), dtype=torch.uint8,
                      device=x.device)
    base = buf.data_ptr()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = launch(out_s.data_ptr(), out_i.data_ptr(), base, base + part,
                     base + 2 * part, stream)
    if err:
        raise RuntimeError(f"{fn.__name__} kernel launch failed: CUDA error "
                           f"{err} (N={x.shape[0]}, B={b}, k={k})")
    fn.launches += 1
    fn.launches_subset += masked
    return out_s, out_i


def _align16(nbytes: int) -> int:
    return -(-nbytes // 16) * 16


def _num_valid(n: int, num_valid) -> int:
    return n if num_valid is None else max(0, min(int(num_valid), n))


def topk_matmul(x: torch.Tensor, q: torch.Tensor, k: int = 10,
                num_valid: "int | None" = None,
                mask: "torch.Tensor | None" = None):
    """K1: fused top-k over ``x`` for queries ``q``; see the module
    docstring. ``mask``: optional ``[1, N]`` (or ``[N]``) int8 allow-list.
    On CUDA a bf16 store scores on the tensor cores, an f32 store on the
    CUDA cores."""
    _check_args(x, q, k)
    if x.device.type == "cpu":
        return topk_matmul_reference(x, q, k, num_valid, mask)
    n, d = x.shape
    b = q.shape[0]
    if d % 8:
        raise ValueError(f"D={d}: the kernel reads rows as 16-byte vectors "
                         f"and needs D % 8 == 0")
    q = q.to(x.dtype)
    mask = _cuda_operands(x, mask, q=q)
    nv = _num_valid(n, num_valid)

    from . import _build
    lib = _build.load()
    m_ptr = mask.data_ptr() if mask is not None else None
    if x.dtype == torch.bfloat16:
        qb, rows, slices = _plan(lambda w: lib.isf_topk_mma_smem(w, d, k),
                                 n, d, b, k, x.device, _QB_MMA, _SMEM_LIMIT)

        def launch(out_s, out_i, cand_s, cand_i, _, stream):
            return lib.isf_topk_matmul_mma(
                x.data_ptr(), q.data_ptr(), m_ptr, out_s, out_i, cand_s,
                cand_i, n, d, b, k, nv, qb, rows, slices, stream)
    else:
        qb, rows, slices = _plan(lambda w: lib.isf_topk_pass1_smem(w, d, k),
                                 n, d, b, k, x.device)

        def launch(out_s, out_i, cand_s, cand_i, _, stream):
            return lib.isf_topk_matmul(
                x.data_ptr(), q.data_ptr(), m_ptr, out_s, out_i, cand_s,
                cand_i, n, d, b, k, nv, qb, rows, slices, stream)

    return _launch(topk_matmul, launch, x, b, k, slices,
                   masked=mask is not None)


@functools.lru_cache(maxsize=256)
def _int_plan(int4: bool, n: int, d: int, b: int, k: int, device):
    """K2/K3's ``_plan`` on the tensor-core pass 1, kept per shape: at B=1
    the wrapper's host time is a large part of a call."""
    from . import _build
    lib = _build.load()
    return _plan(lambda w: lib.isf_topk_int_mma_smem(int(int4), w, d, k),
                 n, d, b, k, device, _QB_MMA, _SMEM_LIMIT)


def quantize_query(q: torch.Tensor):
    """The first kernel of K2/K3's launch sequence on its own: ``q [B, D]``
    -> ``(values [B, D] int8, scales [1, B] f32, offsets [B] int32)``,
    values and scales bit for bit ``ops/quantize.py::quantize_rows``'s,
    offsets ``8 * values.sum(1)`` (K3's nibble offset). A CPU tensor takes
    ``quantize_rows``. Counts its launches in ``.launches``."""
    if q.dim() != 2:
        raise ValueError(f"q must be [B, D]; got {tuple(q.shape)}")
    if q.device.type == "cpu":
        qr = quantize_rows(q)
        return (qr.values, qr.scales,
                8 * qr.values.sum(dim=1, dtype=torch.int32))
    qf = q.to(torch.float32).contiguous()
    b, d = qf.shape
    values = torch.empty((b, d), dtype=torch.int8, device=qf.device)
    scales = torch.empty((b,), dtype=torch.float32, device=qf.device)
    offsets = torch.empty((b,), dtype=torch.int32, device=qf.device)
    from . import _build
    lib = _build.load()
    with torch.cuda.device(qf.device):
        err = lib.isf_quantize_rows(
            qf.data_ptr(), values.data_ptr(), scales.data_ptr(),
            offsets.data_ptr(), b, d,
            torch.cuda.current_stream(qf.device).cuda_stream)
    if err:
        raise RuntimeError(f"quantize_query kernel launch failed: CUDA error "
                           f"{err} (B={b}, D={d})")
    quantize_query.launches += 1
    return values, scales.reshape(1, -1), offsets


def _topk_int(fn, ref, x, scales, q, k, num_valid, mask, int4: bool):
    _check_int_args(x, scales, q, k, int4)
    if x.device.type == "cpu":
        return ref(x, scales, q, k, num_valid, mask)
    n = x.shape[0]
    b, d = q.shape
    step = 32 if int4 else 16
    if d % step:
        raise ValueError(
            f"D={d}: the {'int4' if int4 else 'int8'} kernel reads rows as "
            f"16-byte vectors and needs D % {step} == 0")
    if scales.dtype != torch.float32:
        raise ValueError(f"row scales are {scales.dtype}, not float32")
    # the kernel's launch sequence quantizes the f32 query itself, into
    # scratch behind the candidates: values [b, d], scales [b], offsets [b]
    qf = q.to(torch.float32).contiguous()
    x_scale = scales.reshape(-1)
    mask = _cuda_operands(x, mask, x_scale=x_scale, query=qf)
    nv = _num_valid(n, num_valid)
    qb, rows, slices = _int_plan(int4, n, d, b, k, x.device)
    from . import _build
    lib = _build.load()
    values = _align16(b * d)

    def launch(out_s, out_i, cand_s, cand_i, scratch, stream):
        return lib.isf_topk_matmul_int(
            x.data_ptr(), x_scale.data_ptr(), qf.data_ptr(), scratch,
            scratch + values, scratch + values + 4 * b,
            mask.data_ptr() if mask is not None else None,
            out_s, out_i, cand_s, cand_i, n, d, b, k, nv, int(int4), qb, rows,
            slices, stream)

    return _launch(fn, launch, x, b, k, slices, scratch=values + 8 * b,
                   masked=mask is not None)


def topk_matmul_int8(x_int8: torch.Tensor, scales: torch.Tensor,
                     q: torch.Tensor, k: int = 10,
                     num_valid: "int | None" = None,
                     mask: "torch.Tensor | None" = None):
    """K2: fused top-k over int8 rows ``x_int8 [N, D]`` with row ``scales
    [1, N]`` (``ops/quantize.py::quantize_rows``) for float queries ``q [B,
    D]``; see the module docstring."""
    return _topk_int(topk_matmul_int8, topk_matmul_int8_reference, x_int8,
                     scales, q, k, num_valid, mask, int4=False)


def topk_matmul_int4(x_packed: torch.Tensor, scales: torch.Tensor,
                     q: torch.Tensor, k: int = 10,
                     num_valid: "int | None" = None,
                     mask: "torch.Tensor | None" = None):
    """K3: fused top-k over packed int4 rows ``x_packed [N, D/2]`` with row
    ``scales [1, N]`` (``ops/quantize.py::quantize_rows_int4``) for float
    queries ``q [B, D]``; see the module docstring."""
    return _topk_int(topk_matmul_int4, topk_matmul_int4_reference, x_packed,
                     scales, q, k, num_valid, mask, int4=True)


# kernel launches, and those with a subset mask; reset by whoever counts
# them
for _fn in (topk_matmul, topk_matmul_int8, topk_matmul_int4):
    _fn.launches = _fn.launches_subset = 0
quantize_query.launches = 0
