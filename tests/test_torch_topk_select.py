"""The selection arithmetic of the TMA + wgmma pass 1 on the card
(``instsearch_torch/csrc/topk_wgmma.cuh``: K1 over a bf16 or f32 store, K2
over int8 and K3 over int4 rows) and pass 2
(``topk_common.cuh::topk_pass2``), emulated in torch on the CPU and held to
the plain version bit for bit.

K1's scores are f32 sums of exact bf16 products or of split-TF32 products
(tests/test_torch_topk_f32.py holds those to the plain version's), K2/K3's
exact integer sums scaled as their plain versions scale them
(tests/test_torch_topk_int.py holds the card's sums to those); the
emulation takes the plain version's own scores (``masked_scores``,
``_int_scores``), so any difference would be the selection's. What it
emulates, step for step:
  * the plan: the query block the wrapper's ``_plan`` takes for B and k,
    and that block's append buffers (``wgmma_layout`` of the store's kind:
    their entries a query), slices of ``rows_per_slice`` rows, tiles of
    128 rows in position order within a slice, rows at or past the slice's
    valid end or masked never checked;
  * a tile's passing entries: score > the query's threshold (as it was
    when the tile was checked), appended after the buffer's count in one
    order the card's shared-memory atomics may hand out the slots (warp,
    row tile, row half, lane); when an entry of the consumer warpgroup (the
    half query block that keeps these lists) finds its buffer full, a
    round merges every one of its buffers more than half full, their counts
    restart and the entries left over take slots again, until all are
    placed;
  * a merge: the entries that still beat the list's k-th, compacted in
    order, sorted by the bitonic network of 32 E entries (E = 1, 2, 4, 8,
    the fewest that hold them, padded with (-inf, -1)), and merged by
    ranks: a buffer entry's index plus b_j, its count of better list
    entries; a list entry's index plus the count of b_j not above it; list
    entries before the best entry's rank untouched; the threshold raised
    only at a merge; the buffers' rest merged at the slice's end;
  * pass 2: each of W warps merges slices w, w + W, ... whose best entry
    beats its list's k-th, then the warps' lists pairwise in a tree.

Every test runs with one intra-op thread (the suite's workers share the
cores).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instsearch_tpu.kernels import topk_matmul as jax_topk_matmul
from instsearch_torch.kernels.topk_matmul import (
    _QB_WG, _SMEM_LIMIT, _int_scores, _valid_rows, topk_matmul,
    topk_matmul_int4_reference, topk_matmul_int8_reference,
    topk_matmul_reference, wg_candidate_lists, wgmma_layout)
from instsearch_torch.ops.quantize import quantize_rows, quantize_rows_int4
from instsearch_torch.search.bruteforce import masked_scores

TILE = 128
# the kernel's slot order of a tile's 128 rows: consumer warp v, row tile
# rt, row half h, lane group g (row 64 rt + 16 v + 8 h + g)
ORDER = torch.tensor([64 * rt + 16 * v + 8 * h + g for v in range(4)
                      for rt in range(2) for h in range(2)
                      for g in range(8)])
MERGE_SMEM = 96 * 1024      # kMergeSmem, pass 2's lists a block keeps
MERGE_WARPS = 32            # kMergeMaxWarps
NEG = float("-inf")


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


def better(s1, p1, s2, p2):
    """(score desc, position asc), as ``topk_common.cuh::better``."""
    return (s1 > s2) | ((s1 == s2) & (p1 < p2))


def count_better(ls, lp, s, p):
    """For each (s, p): the entries of the sorted list ls/lp better than it
    (a prefix: what the kernel's binary search finds)."""
    return better(ls[None, :], lp[None, :], s[:, None], p[:, None]).sum(1)


def bitonic(s, p):
    """``wg_sort``: sort len(s) (32 E) entries best first; entry i is lane
    i % 32's register i // 32 on the card, the network the same."""
    s, p = s.clone(), p.clone()
    n = s.numel()
    t = torch.arange(n // 2)
    size = 2
    while size <= n:
        j = size // 2
        while j > 0:
            lo = ((t & ~(j - 1)) << 1) | (t & (j - 1))
            hi = lo + j
            a, b, pa, pb = s[lo], s[hi], p[lo], p[hi]
            desc = (lo & size) == 0
            swap = torch.where(desc, better(b, pb, a, pa),
                               better(a, pa, b, pb))
            s[lo], s[hi] = torch.where(swap, b, a), torch.where(swap, a, b)
            p[lo], p[hi] = torch.where(swap, pb, pa), torch.where(swap, pa, pb)
            j //= 2
        size *= 2
    return s, p


def merge(ls, lp, bs, bp):
    """``wg_merge``: the buffer's entries into the list of k."""
    k = ls.numel()
    keep = better(bs, bp, ls[k - 1], lp[k - 1])
    bs, bp = bs[keep], bp[keep]           # compacted in order
    nv = bs.numel()
    if nv == 0:
        return ls, lp
    p2 = 32                              # 32 E, E = 1, 2, 4, 8
    while p2 < nv:
        p2 *= 2
    bs = torch.cat([bs, torch.full((p2 - nv,), NEG)])
    bp = torch.cat([bp, torch.full((p2 - nv,), -1, dtype=torch.long)])
    bs, bp = bitonic(bs, bp)
    bs, bp = bs[:nv], bp[:nv]
    before = count_better(ls, lp, bs, bp)   # b_j, not falling with j
    rb = torch.arange(nv) + before
    start = int(rb[0])
    out_s, out_p = ls.clone(), lp.clone()
    written = torch.zeros(k, dtype=torch.long)
    written[:start] = 1
    i = torch.arange(start, k)
    # list entry i has the buffer entries with b_j <= i before it
    r = i + torch.searchsorted(before, i, right=True)
    for idx, rank, vals in ((i, r, (ls[start:], lp[start:])),
                            (torch.arange(nv), rb, (bs, bp))):
        ok = rank < k
        out_s[rank[ok]], out_p[rank[ok]] = vals[0][ok], vals[1][ok]
        written.index_add_(0, rank[ok], torch.ones_like(rank[ok]))
    assert bool((written == 1).all()), "ranks are not a permutation"
    return out_s, out_p


def sorted_merge(ls, lp, bs, bp):
    """The same list as ``merge`` by a plain sort: the answer of a merge is
    exact, so the warpgroup's other queries (whose lists only decide when
    its rounds come) take this quicker road."""
    k = ls.numel()
    s, p = torch.cat([ls, bs]), torch.cat([lp, bp])
    p = torch.where(torch.isneginf(s), torch.iinfo(torch.long).max, p)
    order = torch.argsort(p, stable=True)
    order = order[torch.argsort(-s[order], stable=True)][:k]
    s, p = s[order], p[order]
    return s, torch.where(torch.isneginf(s), -1, p)


def wg_select(sc, ok, row_begin, row_end, num_valid, k, cap, tracked,
              first=0, step=1):
    """The lists of one consumer warpgroup's queries (the rows of ``sc``,
    f32 scores [Q, N]) over one slice, over its tiles ``first``, ``first +
    step``, ...; ``ok`` the rows they may return (num valid and the mask).
    A round, when an entry found its buffer full, merges every buffer more
    than half full; the queries of ``tracked`` take ``merge``, the card's
    arithmetic."""
    nq = sc.shape[0]
    ls = [torch.full((k,), NEG) for _ in range(nq)]
    lp = [torch.full((k,), -1, dtype=torch.long) for _ in range(nq)]
    thr = torch.full((nq,), NEG)
    empty = (torch.empty(0), torch.empty(0, dtype=torch.long))
    buf = [empty] * nq
    valid_end = min(row_end, num_valid)

    def take(q, s_new, p_new):      # slots from the count: buffer, or left
        room = cap - buf[q][0].numel()
        buf[q] = (torch.cat([buf[q][0], s_new[:room]]),
                  torch.cat([buf[q][1], p_new[:room]]))
        return (s_new[room:], p_new[room:]) if s_new.numel() > room else None

    for r0 in range(row_begin + first * TILE, valid_end, step * TILE):
        rows = r0 + ORDER
        live = rows < valid_end
        rows = rows.clamp(max=sc.shape[1] - 1)
        passing = live & ok[rows] & (sc[:, rows] > thr[:, None])
        left = {}
        for q in torch.nonzero(passing.any(1)).flatten().tolist():
            rest = take(q, sc[q, rows][passing[q]], rows[passing[q]])
            if rest is not None:
                left[q] = rest
        while left:
            for q in range(nq):
                count = buf[q][0].numel() + (left[q][0].numel()
                                             if q in left else 0)
                if 2 * count <= cap:
                    continue
                fn = merge if q in tracked else sorted_merge
                ls[q], lp[q] = fn(ls[q], lp[q], *buf[q])
                buf[q] = empty
                thr[q] = ls[q][k - 1]
            left = {q: rest for q, (s_new, p_new) in left.items()
                    if (rest := take(q, s_new, p_new)) is not None}
    for q in range(nq):
        if buf[q][0].numel():
            fn = merge if q in tracked else sorted_merge
            ls[q], lp[q] = fn(ls[q], lp[q], *buf[q])
    return ls, lp


def warp_merge(a_s, a_p, b_s, b_p):
    """``topk_common.cuh::warp_merge``: a <- the top k of a and b."""
    k = a_s.numel()
    c_s, c_p = torch.full((k,), NEG), torch.full((k,), -1, dtype=torch.long)
    for (xs, xp), (ys, yp) in (((a_s, a_p), (b_s, b_p)),
                               ((b_s, b_p), (a_s, a_p))):
        r = torch.arange(k) + count_better(ys, yp, xs, xp)
        c_s[r[r < k]], c_p[r[r < k]] = xs[r < k], xp[r < k]
    return c_s, c_p


def pass2(cand_s, cand_p):
    """``topk_pass2`` over one query's [slices, k] candidates."""
    slices, k = cand_s.shape
    w_n = max(1, min(MERGE_SMEM // (6 * k * 4), MERGE_WARPS, slices))
    lists = []
    for w in range(w_n):
        a_s = torch.full((k,), NEG)
        a_p = torch.full((k,), -1, dtype=torch.long)
        for sl in range(w, slices, w_n):
            if better(cand_s[sl, 0], cand_p[sl, 0], a_s[k - 1], a_p[k - 1]):
                a_s, a_p = warp_merge(a_s, a_p, cand_s[sl], cand_p[sl])
        lists.append((a_s, a_p))
    step = 1
    while step < w_n:
        for w in range(0, w_n - step, 2 * step):
            (a_s, a_p), (o_s, o_p) = lists[w], lists[w + step]
            if better(o_s[0], o_p[0], a_s[k - 1], a_p[k - 1]):
                lists[w] = warp_merge(a_s, a_p, o_s, o_p)
        step *= 2
    return lists[0]


def query_block(b, k, kind="bfloat16"):
    """The wrapper's ``_plan`` choice of query block for a ``kind`` store."""
    lo, hi = _QB_WG
    qb = lo
    while qb < min(b, hi):
        qb *= 2
    while qb > lo and wgmma_layout(qb, k, kind)[2] > _SMEM_LIMIT:
        qb //= 2
    return qb


def emulate(x, q, k, rows_per_slice, queries, num_valid=None, mask=None,
            kind="bfloat16"):
    """The card's answer for ``queries`` (indices into q) over the store
    ``x`` (bf16 or f32 rows, or ``QuantizedRows`` of the int8 / int4
    ``kind``): (scores [len, k] f32, positions [len, k] int32) and the
    buffer's entries a query. Each is emulated with the other queries its
    consumer warpgroup keeps (half a query block), whose buffers share its
    rounds; int4 and f32 at a query block of 8: each consumer takes
    alternate row tiles of a slice with all 8 queries in lists of its own,
    two candidate lists a slice for pass 2 (``wg_candidate_lists``)."""
    b = q.shape[0]
    qb = query_block(b, k, kind)
    stages, cap, _ = wgmma_layout(qb, k, kind)
    assert stages, (qb, k)
    if kind in ("bfloat16", "float32"):
        sc = masked_scores(x, q)
    else:
        sc = _int_scores(x.values, x.scales, q, kind == "int4")
        x = x.values
    n = x.shape[0]
    ok = _valid_rows(n, num_valid, mask, x.device)
    nv = n if num_valid is None else num_valid
    split = wg_candidate_lists(qb, 1, kind) == 2
    half = qb if split else qb // 2
    answers = {}
    for g0 in sorted({qi // half * half for qi in queries}):
        group = list(range(g0, min(g0 + half, b)))
        tracked = {group.index(qi) for qi in queries if qi in group}
        slices = [wg_select(sc[group], ok, r0, min(n, r0 + rows_per_slice),
                            nv, k, cap, tracked, *tiles)
                  for r0 in range(0, n, rows_per_slice)
                  for tiles in (((0, 2), (1, 2)) if split else ((0, 1),))]
        for i in tracked:
            s, p = pass2(torch.stack([sl[0][i] for sl in slices]),
                         torch.stack([sl[1][i] for sl in slices]))
            answers[group[i]] = (s, p.to(torch.int32))
    return (torch.stack([answers[qi][0] for qi in queries]),
            torch.stack([answers[qi][1] for qi in queries]), cap)


def _case(case, rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    num_valid = mask = None
    if case == "duplicates":
        x = np.concatenate([x[:250]] * (n // 250 + 1))[:n]
    elif case == "mask50":
        mask = torch.from_numpy((rng.random(n) < 0.5).astype(np.int8))
    elif case == "num_valid":
        num_valid = 2048 + 1000          # inside the second slice
    elif case == "few_valid":            # fewer valid rows than most k
        num_valid = 7
    elif case == "empty_slice":          # the second slice: no valid row
        m = (rng.random(n) < 0.7).astype(np.int8)
        m[2048:4096] = 0
        mask = torch.from_numpy(m)
    return x, num_valid, mask


# the store kinds: (rows from f32, the plain version)
KINDS = {
    "bfloat16": (lambda x: x.bfloat16(), topk_matmul_reference),
    "float32": (lambda x: x, topk_matmul_reference),
    "int8": (quantize_rows, lambda x, q, *a: topk_matmul_int8_reference(
        x.values, x.scales, q, *a)),
    "int4": (quantize_rows_int4, lambda x, q, *a: topk_matmul_int4_reference(
        x.values, x.scales, q, *a)),
}
# the append buffer's entries a query at B = 128 by kind and k: narrower
# than a tile wherever the lists are long; K2/K3's buffers at most 64;
# int4's and f32's stages hold two query planes, so their buffers are
# narrower still where 3 stages are all that fits
CAPS = {"bfloat16": {1: 80, 10: 80, 32: 64, 33: 80, 100: 144, 200: 96,
                     1024: 192},
        "float32": {1: 64, 10: 64, 32: 48, 33: 32, 100: 80, 200: 48,
                    1024: 128},
        "int8": dict.fromkeys((1, 10, 32, 33, 100, 200, 1024), 64),
        "int4": {1: 64, 10: 64, 32: 32, 33: 32, 100: 64, 200: 48,
                 1024: 64}}


@pytest.mark.parametrize("kind", ["bfloat16", "float32", "int8", "int4"])
@pytest.mark.parametrize("case", ["duplicates", "mask50", "num_valid",
                                  "few_valid", "empty_slice"])
@pytest.mark.parametrize("k", [1, 10, 32, 33, 100, 200, 1024])
def test_selection_equals_plain_version(k, case, kind):
    """Three queries of a B = 128 batch (the query block, and so the
    buffers, of the kernel's plan at k for the store's kind) over 6,000
    rows (bf16, f32, or int8 / int4 quantized from the same rows;
    "duplicates"
    gives exact ties, "few_valid" 7 valid rows and two slices with none)
    in slices of 2,048 (16 tiles, the last slice ragged), bit for bit."""
    rng = np.random.default_rng(k)
    n, d, b = 6000, 64, 128
    xn, num_valid, mask = _case(case, rng, n, d)
    make, ref = KINDS[kind]
    x = make(torch.from_numpy(xn))
    q = torch.from_numpy(rng.standard_normal((b, d)).astype(np.float32))
    queries = [0, 1, b - 1]
    s, p, cap = emulate(x, q, k, 2048, queries, num_valid, mask, kind)
    rs, rp = ref(x, q, k, num_valid, mask)
    assert torch.equal(p, rp[queries]) and torch.equal(s, rs[queries])
    assert cap == CAPS[kind][k]


@pytest.mark.parametrize("kind", ["bfloat16", "float32", "int8", "int4"])
@pytest.mark.parametrize("case", ["duplicates", "empty_slice"])
@pytest.mark.parametrize("k", [10, 100, 1024])
def test_selection_at_a_query_block_of_8(k, case, kind):
    """B = 8, the query block of 8: K1's bf16 and K2's consumers each keep
    4 queries over every tile; K1's f32 and K3's take alternate row tiles,
    each keeping all 8 queries in lists of its own, two candidate lists a
    slice (16 tiles a slice: 8 each; the last slice ragged, 6,000 rows),
    bit for bit (f32's buffers: 192 entries at k = 1024, where its 2 KB
    query planes a stage leave no room for 256)."""
    rng = np.random.default_rng(k + 1)
    n, d, b = 6000, 64, 8
    xn, num_valid, mask = _case(case, rng, n, d)
    make, ref = KINDS[kind]
    x = make(torch.from_numpy(xn))
    q = torch.from_numpy(rng.standard_normal((b, d)).astype(np.float32))
    queries = [0, 5, 7]
    s, p, cap = emulate(x, q, k, 2048, queries, num_valid, mask, kind)
    rs, rp = ref(x, q, k, num_valid, mask)
    assert torch.equal(p, rp[queries]) and torch.equal(s, rs[queries])
    assert query_block(b, k, kind) == 8
    assert cap == {"bfloat16": 256, "float32": 192 if k == 1024 else 256
                   }.get(kind, 64)


def test_buffer_rounds_and_merges_are_exercised():
    """The first tile of a slice passes all 128 rows: with 80-entry
    buffers (B = 128, k = 10) its first 80 entries fill the buffer, the
    round merges them and the other 48 start it again; later rounds,
    which other queries of the warpgroup start, merge it while it is more
    than half full. The emulation's answer is still the plain version's."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((4096, 32)).astype(
        np.float32)).bfloat16()
    q = torch.from_numpy(rng.standard_normal((128, 32)).astype(np.float32))
    calls = []
    real = merge

    def counting(*args):
        calls.append(args[2].numel())
        return real(*args)

    globals()["merge"] = counting
    try:
        s, p, cap = emulate(x, q, 10, 4096, [5])
    finally:
        globals()["merge"] = real
    rs, rp = topk_matmul_reference(x, q, 10)
    assert cap == 80 and calls[0] == 80
    assert any(40 < c < 80 for c in calls[1:])
    assert torch.equal(p, rp[[5]]) and torch.equal(s, rs[[5]])


def test_emulation_matches_pallas_kernel():
    """A small case against the JAX kernel run in interpret mode (as
    test_torch_topk_matmul.py runs it): ids equal, scores to 1e-4 (the
    two sum in other orders)."""
    rng = np.random.default_rng(3)
    X = rng.standard_normal((512, 64)).astype(np.float32)
    Q = rng.standard_normal((8, 64)).astype(np.float32)
    js, ji = jax_topk_matmul(jnp.asarray(X, jnp.bfloat16), jnp.asarray(Q),
                             k=10, tile_n=128, interpret=True)
    x = torch.from_numpy(X).bfloat16()
    s, p, _ = emulate(x, torch.from_numpy(Q), 10, 256, list(range(8)))
    np.testing.assert_array_equal(p.numpy(), np.asarray(ji))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-4,
                               atol=1e-4)
    # and the port's wrapper on the CPU (its plain version) agrees
    ws, wp = topk_matmul(x, torch.from_numpy(Q), k=10)
    assert torch.equal(wp, p) and torch.equal(ws, s)
