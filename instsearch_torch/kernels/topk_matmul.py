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
(``instsearch_torch/csrc/topk_matmul.cu``, ``topk_matmul_int.cu``; every
store, bf16, f32, int8 and int4, scores by TMA and wgmma in the one pass 1
of ``topk_wgmma.cuh``, an f32 store by split TF32) for tensors on a CUDA
device and takes its plain PyTorch version (``*_reference``) for tensors on
the CPU. A CUDA tensor the kernel cannot take raises; nothing falls back.
Each counts its kernel launches in ``.launches``, and those given a subset
``mask`` in ``.launches_subset`` too; the launches through the TMA + wgmma
pass 1 (every one) in ``.launches_wgmma`` as well, and K1's over an f32
store in ``topk_matmul.launches_f32``.

Semantics shared by the kernels, their plain versions and the TPU kernels:
  * K1: the query is cast to the store's dtype first, products accumulate
    in f32 (an f32 store's products by split TF32 on the card, each within
    ~2^-22 of the f32 product and exact on integer rows of up to 23
    significant bits: ``csrc/topk_wgmma.cuh``, ``WgF32``);
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
_CHUNK = 256            # rows a slice is a multiple of; kChunk in
#                         topk_common.cuh
_SMEM_LIMIT = 232_448   # the 227 KB a Hopper block may use
_QB_WG = (8, 128)       # query blocks of the TMA + wgmma pass 1
_WG_ROWS = 128          # store rows a stage of it; kWgRows in topk_wgmma.cuh
# its tile policies: (query planes of 128 bytes a query in a stage, a
# staged (scale, offset) a query, the consumers splitting the row tiles at a
# query block of 8, each with lists of its own, the longest append buffer);
# kPlanes, kFactors, kSplit, kCapMax in topk_wgmma.cuh (f32: the query's
# TF32 hi and lo planes)
_WG_KINDS = {"bfloat16": (1, False, False, 256), "int8": (1, True, False, 64),
             "int4": (2, True, True, 64), "float32": (2, False, True, 256)}
# its ring stages, each with the fewest buffer entries a query it takes
# (None: the kind's longest), in the order it tries them; wg_layout in
# topk_wgmma.cuh
_WG_PLANS = ((8, None), (6, None), (4, 64), (3, 32))
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
          qbs: tuple[int, int], budget: int) -> tuple[int, int, int]:
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


def wgmma_layout(qb: int, k: int, kind: str = "bfloat16"
                 ) -> "tuple[int, int, int]":
    """The TMA + wgmma pass 1 over a ``kind`` store (``"bfloat16"`` and
    ``"float32"`` K1, ``"int8"`` K2, ``"int4"`` K3) for a query block of
    ``qb`` and lists of ``k``: (ring stages, append-buffer entries a query,
    shared memory in bytes) as ``csrc/topk_wgmma.cuh::wg_layout`` plans
    them; (0, 0, huge) if none fits. The ring's stages hold 128 rows and
    ``qb`` queries x 128 bytes in each query plane (int4: two, its lo and
    hi columns; f32: two, the query's TF32 hi and lo parts); the lists and
    buffers 8 bytes an entry, the buffers as long as fits (a multiple of
    16, at most 256; K2/K3 64); K2/K3 add 8 bytes a query of factors, and
    K3 and the f32 store at a query block of 8 keep two lists (and buffers)
    a query (``wg_candidate_lists``) and a "full" barrier a stage for each
    consumer."""
    planes, factors, _, cap_max = _WG_KINDS[kind]
    lists = wg_candidate_lists(qb, 1, kind) * qb
    stage = 128 * _WG_ROWS + 128 * qb * planes
    for stages, least in _WG_PLANS:
        fixed = (stage * stages + 8 * lists * k + 8 * lists
                 + 8 * qb * factors + 256 + 8 * (lists // qb + 1) * stages
                 + 1024)
        cap = min(cap_max, max(0, _SMEM_LIMIT - fixed) // (8 * lists)
                  // 16 * 16)
        if fixed <= _SMEM_LIMIT and cap >= (least or cap_max):
            return stages, cap, fixed + 8 * lists * cap
    return 0, 0, 1 << 62


def wg_candidate_lists(qb: int, slices: int, kind: str) -> int:
    """The candidate lists a query gets from the TMA + wgmma pass 1 over
    ``slices`` slices, which pass 2 merges: one a slice, or two where the
    two consumer warpgroups take alternate row tiles of a slice (K3 and
    K1's f32 store at a query block of 8, where both would otherwise
    compute the same 8 queries' products);
    ``topk_wgmma.cuh::wg_candidate_lists``."""
    return slices * (2 if _WG_KINDS[kind][2] and qb == 8 else 1)


@functools.lru_cache(maxsize=256)
def _wg_plan(kind: str, n: int, d: int, b: int, k: int, device):
    """``_plan`` on the TMA + wgmma pass 1 over a ``kind`` store, kept per
    shape (at B=1 the wrapper's host time is a large part of a call): the
    widest query block whose stages, lists and buffers fit
    (``wgmma_layout``; D does not count)."""
    return _plan(lambda w: wgmma_layout(w, k, kind)[2], n, d, b, k, device,
                 _QB_WG, _SMEM_LIMIT)


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


# codes of a C entry that launched nothing for want of a TMA tensor map
_NO_ENCODER, _MAP_REFUSED = -1, -2


def _launch(fn, launch, x, b: int, k: int, slices: int, scratch: int = 0,
            masked: bool = False):
    """Allocate the outputs, and the candidates (f32 scores, int32
    positions, ``b * slices * k`` each, ``slices`` the candidate lists a
    query) and ``scratch`` more bytes in one
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
    if err == _MAP_REFUSED:
        raise ValueError(f"{fn.__name__}: the tensor-map encoder refused the "
                         f"operands (N={x.shape[0]}, B={b})")
    if err:
        why = ("libcuda has no tensor-map encoder" if err == _NO_ENCODER
               else f"CUDA error {err}")
        raise RuntimeError(f"{fn.__name__} kernel launch failed: {why} "
                           f"(N={x.shape[0]}, B={b}, k={k})")
    fn.launches += 1
    fn.launches_subset += masked
    return out_s, out_i


def _align16(nbytes: int) -> int:
    return -(-nbytes // 16) * 16


def _num_valid(n: int, num_valid) -> int:
    return n if num_valid is None else max(0, min(int(num_valid), n))


def topk_matmul(x: torch.Tensor, q: torch.Tensor, k: int = 10,
                num_valid: "int | None" = None, *,
                mask: "torch.Tensor | None" = None):
    """K1: fused top-k over ``x`` for queries ``q``; see the module
    docstring. ``mask``: optional ``[1, N]`` (or ``[N]``) int8 allow-list.
    On CUDA both stores score on the tensor cores by TMA and wgmma: bf16
    directly, f32 by split TF32 (the launch sequence splits the query into
    TF32 hi and lo planes first)."""
    _check_args(x, q, k)
    if x.device.type == "cpu":
        return topk_matmul_reference(x, q, k, num_valid, mask)
    n, d = x.shape
    b = q.shape[0]
    if d % 8:
        raise ValueError(f"D={d}: the kernel loads rows by TMA in 16-byte "
                         f"multiples and needs D % 8 == 0")
    q = q.to(x.dtype)
    mask = _cuda_operands(x, mask, q=q)
    nv = _num_valid(n, num_valid)

    from . import _build
    lib = _build.load()
    m_ptr = mask.data_ptr() if mask is not None else None
    f32 = x.dtype == torch.float32
    kind = "float32" if f32 else "bfloat16"
    qb, rows, slices = _wg_plan(kind, n, d, b, k, x.device)

    def launch(out_s, out_i, cand_s, cand_i, scratch, stream):
        if f32:     # the query's TF32 planes in the scratch
            return lib.isf_topk_matmul_f32_wgmma(
                x.data_ptr(), q.data_ptr(), scratch, m_ptr, out_s, out_i,
                cand_s, cand_i, n, d, b, k, nv, qb, rows, slices, stream)
        return lib.isf_topk_matmul_wgmma(
            x.data_ptr(), q.data_ptr(), m_ptr, out_s, out_i, cand_s, cand_i,
            n, d, b, k, nv, qb, rows, slices, stream)

    out = _launch(topk_matmul, launch, x, b, k,
                  wg_candidate_lists(qb, slices, kind),
                  scratch=8 * b * d if f32 else 0, masked=mask is not None)
    topk_matmul.launches_wgmma += 1
    topk_matmul.launches_f32 += f32
    return out


def int_query_bytes(b: int, d: int, int4: bool) -> int:
    """Bytes of K2/K3's quantized query in the launch's scratch: int8 [b, d]
    as it lies; int4 as its query planes [2 c][b][128], c = ceil(d / 256)
    chunks of 128 packed bytes a row (plane 2 j: columns 128 j ..; 2 j + 1:
    columns d / 2 + 128 j ..; zero past d / 2)."""
    return b * 256 * _cdiv(d, 256) if int4 else b * d


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
            f"D={d}: the {'int4' if int4 else 'int8'} kernel loads rows by "
            f"TMA in multiples of 16 bytes and needs D % {step} == 0")
    if scales.dtype != torch.float32:
        raise ValueError(f"row scales are {scales.dtype}, not float32")
    # the kernel's launch sequence quantizes the f32 query itself, into
    # scratch behind the candidates: values (``int_query_bytes``), scales
    # [b], offsets [b]
    qf = q.to(torch.float32).contiguous()
    x_scale = scales.reshape(-1)
    mask = _cuda_operands(x, mask, x_scale=x_scale, query=qf)
    nv = _num_valid(n, num_valid)
    kind = "int4" if int4 else "int8"
    qb, rows, slices = _wg_plan(kind, n, d, b, k, x.device)
    from . import _build
    lib = _build.load()
    values = _align16(int_query_bytes(b, d, int4))

    def launch(out_s, out_i, cand_s, cand_i, scratch, stream):
        return lib.isf_topk_matmul_int(
            x.data_ptr(), x_scale.data_ptr(), qf.data_ptr(), scratch,
            scratch + values, scratch + values + 4 * b,
            mask.data_ptr() if mask is not None else None,
            out_s, out_i, cand_s, cand_i, n, d, b, k, nv, int(int4), qb, rows,
            slices, stream)

    lists = wg_candidate_lists(qb, slices, kind)
    out = _launch(fn, launch, x, b, k, lists, scratch=values + 8 * b,
                  masked=mask is not None)
    fn.launches_wgmma += 1
    return out


def topk_matmul_int8(x_int8: torch.Tensor, scales: torch.Tensor,
                     q: torch.Tensor, k: int = 10,
                     num_valid: "int | None" = None, *,
                     mask: "torch.Tensor | None" = None):
    """K2: fused top-k over int8 rows ``x_int8 [N, D]`` with row ``scales
    [1, N]`` (``ops/quantize.py::quantize_rows``) for float queries ``q [B,
    D]``; see the module docstring."""
    return _topk_int(topk_matmul_int8, topk_matmul_int8_reference, x_int8,
                     scales, q, k, num_valid, mask, int4=False)


def topk_matmul_int4(x_packed: torch.Tensor, scales: torch.Tensor,
                     q: torch.Tensor, k: int = 10,
                     num_valid: "int | None" = None, *,
                     mask: "torch.Tensor | None" = None):
    """K3: fused top-k over packed int4 rows ``x_packed [N, D/2]`` with row
    ``scales [1, N]`` (``ops/quantize.py::quantize_rows_int4``) for float
    queries ``q [B, D]``; see the module docstring."""
    return _topk_int(topk_matmul_int4, topk_matmul_int4_reference, x_packed,
                     scales, q, k, num_valid, mask, int4=True)


# kernel launches, and those with a subset mask; reset by whoever counts
# them
for _fn in (topk_matmul, topk_matmul_int8, topk_matmul_int4):
    _fn.launches = _fn.launches_subset = _fn.launches_wgmma = 0
topk_matmul.launches_f32 = 0    # K1's launches over an f32 store
quantize_query.launches = 0
