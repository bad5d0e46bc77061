"""K2 and K3 of the port (instsearch_torch.kernels.topk_matmul_int8 /
topk_matmul_int4) against the JAX Pallas kernels run in interpret mode on
the CPU, as tests/kernels/test_topk_int8.py and test_topk_int4.py run them;
and the int8/int4 scoring oracle and alpha-QE against the reference's.

On the CPU each wrapper takes its plain version; the CUDA kernels are held
to the same plain versions on the card (tests/test_torch_gpu.py,
chip_smoke.py).

Tolerances. The kernels: none. Both sides quantize the query with
byte-identical functions, sum int8 products exactly in int32 and scale with
the same two f32 products, so ids and scores must be equal bit for bit,
ties included. The oracle (an f32 query against the stored integers) and
alpha-QE: rtol = atol = 1e-5 on scores, since the two sides sum f32 products
in different orders; ids equal, since random normal scores at these sizes
lie far further apart.
"""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instsearch_tpu.kernels import topk_matmul_int4 as jax_int4
from instsearch_tpu.kernels import topk_matmul_int8 as jax_int8
from instsearch_tpu.ops.quantize import quantize_rows as jax_quantize_rows
from instsearch_tpu.ops.quantize import quantize_rows_int4 as jax_quantize_int4
from instsearch_tpu.search import bruteforce as jbf
from instsearch_tpu.search import qe as jqe
from instsearch_torch.kernels import (topk_matmul, topk_matmul_int4,
                                      topk_matmul_int8)
from instsearch_torch.kernels.topk_matmul import (_int_scores, check_exact,
                                                  int_query_bytes,
                                                  quantize_query)
from instsearch_torch.ops.quantize import (quantize_rows, quantize_rows_int4,
                                           unpack_int4)
from instsearch_torch.search import bruteforce as tbf
from instsearch_torch.search import qe as tqe
from instsearch_torch.search.bruteforce import select_topk

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from chip_smoke import quantizer_rows  # noqa: E402

_KINDS = {
    "int8": (quantize_rows, jax_quantize_rows, topk_matmul_int8, jax_int8),
    "int4": (quantize_rows_int4, jax_quantize_int4, topk_matmul_int4,
             jax_int4),
}


def _both(kind, X, Q, k, tile, num_valid=None, mask=None):
    """(jax scores, jax ids, port scores, port ids) as numpy; the store is
    quantized by each package from the same f32 rows."""
    tquant, jquant, tfn, jfn = _KINDS[kind]
    jr = jquant(jnp.asarray(X))
    js, ji = jfn(jr.values, jr.scales, jnp.asarray(Q), k=k, tile_n=tile,
                 num_valid=num_valid, interpret=True,
                 mask=None if mask is None else jnp.asarray(mask))
    tr = tquant(torch.from_numpy(X))
    before = tfn.launches
    ps, pi = tfn(tr.values, tr.scales, torch.from_numpy(Q), k=k,
                 num_valid=num_valid,
                 mask=None if mask is None else torch.from_numpy(mask))
    assert tfn.launches == before            # a CPU store launches nothing
    return np.asarray(js), np.asarray(ji), ps.numpy(), pi.numpy()


def _assert_exact(js, ji, ps, pi):
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_array_equal(ps.view(np.uint32), js.view(np.uint32))


@pytest.mark.parametrize("kind", ["int8", "int4"])
@pytest.mark.parametrize("n,d,b,k,tile", [
    (512, 128, 3, 10, 128),
    (1024, 64, 8, 32, 256),       # k > 16: the 16-round extraction tier
    (512, 256, 1, 1, 256),        # k = 1
    (256, 512, 2, 100, 128),      # the presets' whitened width
    (384, 2048, 1, 10, 128),      # the unwhitened ResNet-50 width
])
def test_matches_pallas_kernel_exactly(kind, n, d, b, k, tile):
    rng = np.random.default_rng(d + k)
    X = rng.standard_normal((n, d)).astype(np.float32)
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    Q = rng.standard_normal((b, d)).astype(np.float32)
    _assert_exact(*_both(kind, X, Q, k, tile))


@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_num_valid_masks_poisoned_padding(kind):
    rng = np.random.default_rng(2)
    X = rng.standard_normal((256, 64)).astype(np.float32)
    X[200:] = 50.0                            # must never be returned
    Q = rng.standard_normal((2, 64)).astype(np.float32)
    js, ji, ps, pi = _both(kind, X, Q, 10, 128, num_valid=200)
    assert pi.max() < 200
    _assert_exact(js, ji, ps, pi)


@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_subset_mask(kind):
    rng = np.random.default_rng(4)
    X = rng.standard_normal((512, 64)).astype(np.float32)
    Q = rng.standard_normal((3, 64)).astype(np.float32)
    mask = (rng.random((1, 512)) < 0.5).astype(np.int8)
    js, ji, ps, pi = _both(kind, X, Q, 10, 128, mask=mask)
    _assert_exact(js, ji, ps, pi)
    assert mask[0, pi].all()


@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_fewer_valid_rows_than_k(kind):
    rng = np.random.default_rng(3)
    X = rng.standard_normal((128, 32)).astype(np.float32)
    Q = rng.standard_normal((2, 32)).astype(np.float32)
    js, ji, ps, pi = _both(kind, X, Q, 10, 128, num_valid=4)
    _assert_exact(js, ji, ps, pi)
    assert (pi[:, 4:] == -1).all() and np.isneginf(ps[:, 4:]).all()


@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_duplicated_rows_lowest_position_first(kind):
    rng = np.random.default_rng(1)
    base = rng.standard_normal((8, 64)).astype(np.float32)
    X = np.concatenate([base] * 32)           # every row 32 times
    Q = rng.standard_normal((2, 64)).astype(np.float32)
    js, ji, ps, pi = _both(kind, X, Q, 40, 128)
    _assert_exact(js, ji, ps, pi)
    # the best base row's 32 copies first, lowest position first
    assert (pi[:, :32] // 8 == np.arange(32)).all()
    assert (pi[:, :32] % 8 == pi[:, :1] % 8).all()


def test_odd_width_int4_store():
    """The mini fixture's 55-dim whitened rows: an int4 store gains a zero
    column (56 components, 28 bytes per row) and queries a zero component."""
    rng = np.random.default_rng(5)
    X = rng.standard_normal((256, 56)).astype(np.float32)
    X[:, 55] = 0.0
    Q = rng.standard_normal((2, 56)).astype(np.float32)
    Q[:, 55] = 0.0
    _assert_exact(*_both("int4", X, Q, 10, 128))


def test_rejects_what_it_cannot_take():
    qr = quantize_rows_int4(torch.zeros((64, 32)))
    with pytest.raises(ValueError, match="packed"):
        topk_matmul_int4(qr.values, qr.scales, torch.zeros((1, 48)), k=5)
    with pytest.raises(ValueError, match="store dim"):
        topk_matmul_int8(qr.values, qr.scales, torch.zeros((1, 32)), k=5)
    with pytest.raises(ValueError):
        topk_matmul_int8(qr.values.float(), qr.scales, torch.zeros((1, 16)))
    with pytest.raises(ValueError):
        topk_matmul_int8(qr.values, qr.scales[:, :10], torch.zeros((1, 16)))
    with pytest.raises(ValueError):
        topk_matmul_int4(qr.values, qr.scales, torch.zeros((1, 32)), k=0)
    with pytest.raises(ValueError, match="topk_matmul_int8"):
        topk_matmul(qr.values, torch.zeros((1, 16)))


def test_check_exact_rejects_any_difference():
    s = torch.tensor([[3.0, 2.0, float("-inf")]])
    i = torch.tensor([[4, 7, -1]], dtype=torch.int32)
    assert check_exact(s, i, s.clone(), i.clone()) == 0.0
    with pytest.raises(AssertionError, match="positions"):
        check_exact(s, i.flip(1), s, i)
    with pytest.raises(AssertionError, match="scores"):
        check_exact(torch.nextafter(s, torch.zeros(())), i, s, i)


# ---- the card's pass-1 arithmetic, emulated on the CPU -------------------
#
# csrc/topk_wgmma.cuh with the policy WgInt: rows in stages of 128 rows x
# 128 bytes as TMA writes them (zero past the row and the store, 16-byte
# chunk j of row r at j ^ (r % 8)), four k32 steps a chunk, two 64-row
# tiles a stage. int8: A read by the descriptor (the rows' bytes), B the
# query's 128 columns of the chunk. int4: each warp's A fragment gathered
# by ldmatrix from the lane addresses the kernel computes, split in
# registers, and placed by wgmma's fragment layout; B the query planes as
# the quantizer writes them.

_CHUNK_BYTES = 128      # a stage's row bytes
_TILE = 128             # rows a stage (kWgRows)

# the A fragment of one warpgroup's k32 step: warp v, lane l, register i
_V, _L, _I = torch.meshgrid(torch.arange(4), torch.arange(32),
                            torch.arange(4), indexing="ij")
# ldmatrix.x4: register i of lane l holds row l // 4 of matrix i, whose
# rows' addresses lanes 8 i .. 8 i + 7 give: lane p the row 16 v + p % 16,
# 16-byte half p // 16 of the k32 step, at chunk (2 kk + half) ^ (p % 8)
_P = 8 * _I + _L // 4
# wgmma's A fragment: register i of lane l holds row 16 v + l / 4 (+ 8 for
# i odd), bytes 4 (l % 4) .. + 3 (+ 16 for i >= 2)
_M = 16 * _V + _L // 4 + 8 * (_I % 2)
_K = 4 * (_L % 4) + 16 * (_I // 2)


def _swizzled(tile: torch.Tensor) -> torch.Tensor:
    """A [128, 128]-byte stage as TMA's 128-byte swizzle lays it out:
    16-byte chunk j of row r at chunk j ^ (r % 8)."""
    r = torch.arange(tile.shape[0])[:, None]
    j = torch.arange(8)[None, :]
    return tile.view(-1, 8, 16)[r, j ^ (r % 8)].reshape(tile.shape)


def _a_fragment(stage_words: torch.Tensor, kk: int, rt: int) -> torch.Tensor:
    """The words each lane's ldmatrix.x4 gets at k32 step kk of row tile rt
    from the swizzled stage (int32 [128, 32]): [4 warps, 32 lanes, 4]."""
    row = 64 * rt + 16 * _V + _P % 16
    chunk = (2 * kk + _P // 16) ^ (_P % 8)          # the kernel's address
    return stage_words[row, 4 * chunk + _L % 4]


def _a_matrix(words: torch.Tensor) -> torch.Tensor:
    """The 64 x 32-byte A operand that wgmma reads from the fragments'
    registers (int32 words, little-endian bytes)."""
    a = torch.zeros((64, 32), dtype=torch.uint8)
    by = words.contiguous().view(torch.uint8).reshape(4, 32, 4, 4)
    a[_M[..., None], _K[..., None] + torch.arange(4)] = by
    return a


def _query_planes(q_i8: torch.Tensor) -> torch.Tensor:
    """K3's query as ``quantize_query_rows`` writes it for pass 1: planes
    [2 c][B][128], c = ceil(D / 256); plane 2 j holds columns 128 j ..,
    plane 2 j + 1 columns D/2 + 128 j .., zero past D/2."""
    b, d = q_i8.shape
    half, c = d // 2, -(-d // 256)
    planes = torch.zeros((2 * c, b, 128), dtype=torch.int8)
    for p in range(2 * c):
        col = p // 2 * 128 + torch.arange(128)
        ok = col < half
        planes[p][:, ok] = q_i8[:, p % 2 * half + col[ok]]
    return planes


def _kernel_sums(x: torch.Tensor, q_i8: torch.Tensor, q_off: torch.Tensor,
                 int4: bool, planes: "torch.Tensor | None" = None
                 ) -> torch.Tensor:
    """The int32 sums of pass 1 (see above) for stored bytes ``x`` and the
    quantized query; ``planes`` replaces K3's query planes. int4: each
    word of the fragment split into lo + 8 (w & 0x0F0F0F0F) and hi + 8
    (((w >> 4) & 0x0F0F0F0F) ^ 0x08080808), u8 in [0, 15], against the lo
    and the hi plane; then the offset 8 * sum(q) comes off once."""
    n, row_bytes = x.shape
    b, d = q_i8.shape
    chunks = -(-row_bytes // _CHUNK_BYTES)
    tiles = -(-n // _TILE)
    rows = torch.zeros((tiles * _TILE, chunks * _CHUNK_BYTES),
                       dtype=torch.int8)
    rows[:n, :row_bytes] = x
    if int4:
        planes = _query_planes(q_i8) if planes is None else planes
        assert planes.numel() == int_query_bytes(b, d, True)
    else:
        qpad = torch.zeros((b, chunks * _CHUNK_BYTES), dtype=torch.int8)
        qpad[:, :d] = q_i8
        planes = qpad.view(b, chunks, _CHUNK_BYTES).transpose(0, 1)
    planes = planes.to(torch.int64)
    acc = torch.zeros((b, tiles * _TILE), dtype=torch.int64)
    for t in range(tiles):
        for c in range(chunks):
            tile = rows[t * _TILE:(t + 1) * _TILE,
                        c * _CHUNK_BYTES:(c + 1) * _CHUNK_BYTES]
            words = _swizzled(tile).contiguous().view(torch.int32)
            for kk in range(4):
                ks = slice(32 * kk, 32 * kk + 32)
                for rt in range(2):
                    out = acc[:, t * _TILE + 64 * rt:t * _TILE + 64 * rt + 64]
                    if not int4:
                        a = tile[64 * rt:64 * rt + 64, ks].to(torch.int64)
                        out += planes[c][:, ks] @ a.T
                        continue
                    w = _a_fragment(words, kk, rt)
                    lo = _a_matrix(w & 0x0F0F0F0F).to(torch.int64)
                    hi = _a_matrix(((w >> 4) & 0x0F0F0F0F) ^ 0x08080808
                                   ).to(torch.int64)
                    assert int(lo.max()) <= 15 and int(hi.max()) <= 15
                    out += planes[2 * c][:, ks] @ lo.T
                    out += planes[2 * c + 1][:, ks] @ hi.T
    return acc[:, :n] - (q_off.to(torch.int64)[:, None] if int4 else 0)


def _kernel_scores(values, scales, q, int4):
    """The card's scores: float(sum - offset) * q_scale * x_scale."""
    q_i8, q_scale, q_off = quantize_query(q)
    sums = _kernel_sums(values, q_i8, q_off, int4)
    return (sums.to(torch.int32).float() * q_scale.reshape(-1, 1)
            * scales.reshape(1, -1)), sums, q_i8


def test_fragment_gather_reads_the_stage_in_order():
    """The lane addresses of the kernel's ldmatrix (chunk (2 kk + half) ^
    (lane % 8) of row 16 v + lane % 16) on a stage TMA swizzled, placed
    by wgmma's A fragment layout, give each k32 step's 64 x 32 bytes of
    both row tiles as the rows hold them."""
    tile = torch.arange(128 * 128, dtype=torch.int32).to(torch.uint8).view(
        128, 128)
    tile = tile ^ torch.arange(128, dtype=torch.uint8)[:, None]
    words = _swizzled(tile).contiguous().view(torch.int32)
    for kk in range(4):
        for rt in range(2):
            got = _a_matrix(_a_fragment(words, kk, rt))
            assert torch.equal(got, tile[64 * rt:64 * rt + 64,
                                         32 * kk:32 * kk + 32])


@pytest.mark.parametrize("kind", ["int8", "int4"])
@pytest.mark.parametrize("d,pad", [(32, 0), (96, 0), (128, 0), (512, 0),
                                   (2048, 0), (31, 1)])
def test_kernel_chunk_arithmetic_equals_plain_sums(kind, d, pad):
    """The card's arithmetic (``_kernel_sums``) gives the plain version's
    integer sums exactly, and its score formula ``float(acc - offset) *
    q_scale * x_scale`` the plain version's scores bit for bit: at rows
    that fill part of a chunk (int4 D = 32, 96, 128: 16, 48, 64 of 128
    bytes, where the hi plane starts a chunk apart from the lo plane; a
    zero-filled byte unpacks to hi + 8 = 8 and must meet a zero query
    column), over several chunks (D = 2048), a ragged last tile (300
    rows) and at a store padded from D = 31 to 32 with a zero column, as
    the Index pads it."""
    int4 = kind == "int4"
    rng = np.random.default_rng(d + 7 * pad)
    X = rng.standard_normal((300, d + pad)).astype(np.float32)
    Q = rng.standard_normal((5, d + pad)).astype(np.float32)
    X[:, d:] = 0.0
    Q[:, d:] = 0.0
    X[7] = X[3]                                 # an exact tie
    st = (quantize_rows_int4 if int4 else quantize_rows)(torch.from_numpy(X))
    q = torch.from_numpy(Q)
    scores, got, q_i8 = _kernel_scores(st.values, st.scales, q, int4)
    rows = unpack_int4(st.values) if int4 else st.values
    want = q_i8.double() @ rows.double().T      # exact: |sum| < 2^53
    assert torch.equal(got, want.to(torch.int64))
    plain = _int_scores(st.values, st.scales, q, int4)
    assert torch.equal(scores.view(torch.int32), plain.view(torch.int32))


@pytest.mark.parametrize("kind", ["int8", "int4"])
@pytest.mark.parametrize("d", [96, 128, 512, 2048])
def test_kernel_arithmetic_matches_pallas_kernel(kind, d):
    """The card's scores (``_kernel_scores``), ranked (score desc,
    position asc, as the selection ranks them), equal the interpret-mode
    Pallas kernel's top-k bit for bit, with copies of rows for exact
    ties."""
    rng = np.random.default_rng(3 * d + (kind == "int4"))
    X = rng.standard_normal((384, d)).astype(np.float32)
    X[150:180] = X[20]
    Q = rng.standard_normal((3, d)).astype(np.float32)
    quant = quantize_rows_int4 if kind == "int4" else quantize_rows
    st = quant(torch.from_numpy(X))
    scores = _kernel_scores(st.values, st.scales, torch.from_numpy(Q),
                            kind == "int4")[0]
    ps, pi = select_topk(scores, 40)
    js, ji, _, _ = _both(kind, X, Q, 40, 128)
    _assert_exact(js, ji, ps.numpy(), pi.numpy())


def test_kernel_chunk_arithmetic_needs_the_zero_query_columns():
    """The trap the query planes' zero columns guard against: an int4
    row of 16 bytes (D = 32) fills an eighth of a chunk, and each of its
    112 zero-filled bytes unpacks to hi + 8 = 8, so a hi plane with
    anything but zeros past D/2 would move every sum."""
    rng = np.random.default_rng(11)
    X = rng.standard_normal((40, 32)).astype(np.float32)
    st = quantize_rows_int4(torch.from_numpy(X))
    q_i8, _, q_off = quantize_query(torch.from_numpy(
        rng.standard_normal((2, 32)).astype(np.float32)))
    good = _kernel_sums(st.values, q_i8, q_off, int4=True)
    dirty = _query_planes(q_i8)
    dirty[1][:, 16:] = 1
    bad = _kernel_sums(st.values, q_i8, q_off, int4=True, planes=dirty)
    assert bool((bad != good).all())


def test_quantize_query_on_the_cpu_is_quantize_rows():
    """``quantize_query``'s plain version, the one the card is held to
    (tests/test_torch_gpu.py, chip_smoke.py): the reference's
    ``quantize_rows`` bit for bit, on rows with ties at half a step, a
    zero row, signs at the maximum, bf16 values and extreme scales
    (``chip_smoke.quantizer_rows``), and offsets 8 * the row's sum."""
    for d in (16, 512):
        q = quantizer_rows(torch.Generator().manual_seed(d), d)
        values, scales, offsets = quantize_query(q)
        want = jax_quantize_rows(jnp.asarray(q.numpy()))
        np.testing.assert_array_equal(values.numpy(), np.asarray(want.values))
        np.testing.assert_array_equal(scales.numpy().view(np.uint32),
                                      np.asarray(want.scales).view(np.uint32))
        np.testing.assert_array_equal(
            offsets.numpy(), 8 * np.asarray(want.values).astype(
                np.int32).sum(1))
        assert values[1, :8].tolist() == [127, 0, 2, 2, 0, -2, 126, -126]
    assert quantize_query.launches == 0       # a CPU tensor launches nothing


# ---- the scoring oracle and alpha-QE over quantized stores ---------------

def _store(kind, n=300, d=64, seed=6):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)).astype(np.float32)
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    ids = np.arange(n, dtype=np.int32)
    ids[-20:] = -1                            # padding rows
    quant = {"int8": jax_quantize_rows, "int4": jax_quantize_int4}[kind]
    jr = quant(jnp.asarray(X))
    Q = rng.standard_normal((4, d)).astype(np.float32)
    return jr, ids, Q


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_masked_scores_matches_reference(kind):
    jr, ids, Q = _store(kind)
    int4 = kind == "int4"
    want = np.asarray(jbf.masked_scores(jr.values, jnp.asarray(Q),
                                        scales=jr.scales,
                                        ids=jnp.asarray(ids), int4=int4))
    got = tbf.masked_scores(_t(jr.values), _t(Q), scales=_t(jr.scales),
                            ids=_t(ids), int4=int4).numpy()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_alpha_query_expansion_matches_reference(kind):
    jr, ids, Q = _store(kind)
    int4 = kind == "int4"
    want = np.asarray(jqe.alpha_query_expansion(
        jr.values, jnp.asarray(ids), jnp.asarray(Q), n=10, alpha=3.0,
        scales=jr.scales, int4=int4))
    got = tqe.alpha_query_expansion(
        _t(jr.values), _t(ids), _t(Q), n=10, alpha=3.0, scales=_t(jr.scales),
        int4=int4).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)
