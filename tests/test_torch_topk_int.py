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
                                                  quantize_query)
from instsearch_torch.ops.quantize import (quantize_rows, quantize_rows_int4,
                                           unpack_int4)
from instsearch_torch.search import bruteforce as tbf
from instsearch_torch.search import qe as tqe

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

_CHUNK_BYTES = 128      # kMmaBytes in csrc/topk_mma.cuh


def _kernel_sums(x: torch.Tensor, q_i8: torch.Tensor, q_off: torch.Tensor,
                 int4: bool) -> torch.Tensor:
    """The int32 sums of csrc/topk_matmul_int.cu's pass 1, chunk by chunk as
    the card forms them: rows staged in 128-byte chunks, zero-filled past
    the row; the query staged [B, 128 * chunks] (int4: twice that), zero
    past D. int8: each chunk's bytes times query columns c..; int4: each
    32-bit word of the chunk split by the kernel's masks into lo + 8 (w &
    0x0F0F0F0F) and hi + 8 (((w >> 4) & 0x0F0F0F0F) ^ 0x08080808), u8 in
    [0, 15], times query columns c.. and D/2 + c..; then the offset
    8 * sum(q) comes off once."""
    n, row_bytes = x.shape
    d = q_i8.shape[1]
    chunks = -(-row_bytes // _CHUNK_BYTES)
    staged = torch.zeros((n, chunks * _CHUNK_BYTES), dtype=torch.int8)
    staged[:, :row_bytes] = x
    qs = torch.zeros((q_i8.shape[0], (2 if int4 else 1) * chunks
                      * _CHUNK_BYTES), dtype=torch.int64)
    qs[:, :d] = q_i8.to(torch.int64)
    words = staged.view(torch.int32)          # little-endian, as the card's
    acc = torch.zeros((q_i8.shape[0], n), dtype=torch.int64)
    for c0 in range(0, chunks * _CHUNK_BYTES, _CHUNK_BYTES):
        w = words[:, c0 // 4:(c0 + _CHUNK_BYTES) // 4]
        if not int4:
            a = w.contiguous().view(torch.int8).to(torch.int64)
            acc += qs[:, c0:c0 + _CHUNK_BYTES] @ a.T
            continue
        lo = (w & 0x0F0F0F0F).contiguous().view(torch.uint8).to(torch.int64)
        hi = (((w >> 4) & 0x0F0F0F0F) ^ 0x08080808).contiguous().view(
            torch.uint8).to(torch.int64)
        assert int(lo.max()) <= 15 and int(hi.max()) <= 15
        acc += qs[:, c0:c0 + _CHUNK_BYTES] @ lo.T
        acc += qs[:, d // 2 + c0:d // 2 + c0 + _CHUNK_BYTES] @ hi.T
    return acc - (q_off.to(torch.int64)[:, None] if int4 else 0)


@pytest.mark.parametrize("kind", ["int8", "int4"])
@pytest.mark.parametrize("d,pad", [(32, 0), (96, 0), (128, 0), (512, 0),
                                   (2048, 0), (31, 1)])
def test_kernel_chunk_arithmetic_equals_plain_sums(kind, d, pad):
    """The card's per-chunk arithmetic (``_kernel_sums``) gives the plain
    version's integer sums exactly, and its score formula
    ``float(acc - offset) * q_scale * x_scale`` the plain version's scores
    bit for bit: at rows that fill part of a chunk (int4 D = 32, 96, 128:
    16, 48, 64 of 128 bytes; a zero-filled byte unpacks to hi + 8 = 8 and
    must meet a zero query column) and at a store padded from D = 31 to 32
    with a zero column, as the Index pads it."""
    int4 = kind == "int4"
    rng = np.random.default_rng(d + 7 * pad)
    X = rng.standard_normal((300, d + pad)).astype(np.float32)
    Q = rng.standard_normal((5, d + pad)).astype(np.float32)
    X[:, d:] = 0.0
    Q[:, d:] = 0.0
    X[7] = X[3]                                 # an exact tie
    st = (quantize_rows_int4 if int4 else quantize_rows)(torch.from_numpy(X))
    q = torch.from_numpy(Q)
    q_i8, q_scale, q_off = quantize_query(q)
    got = _kernel_sums(st.values, q_i8, q_off, int4)
    rows = unpack_int4(st.values) if int4 else st.values
    want = q_i8.double() @ rows.double().T      # exact: |sum| < 2^53
    assert torch.equal(got, want.to(torch.int64))
    scores = (got.to(torch.int32).float() * q_scale.reshape(-1, 1)
              * st.scales.reshape(1, -1))
    plain = _int_scores(st.values, st.scales, q, int4)
    assert torch.equal(scores.view(torch.int32), plain.view(torch.int32))


def test_kernel_chunk_arithmetic_needs_the_zero_query_columns():
    """The trap the staged query's zero columns guard against: an int4 row
    of 16 bytes (D = 32) fills an eighth of a chunk, and each of its 112
    zero-filled bytes unpacks to hi + 8 = 8, so a query staged with
    anything but zeros past D would move every sum."""
    rng = np.random.default_rng(11)
    X = rng.standard_normal((40, 32)).astype(np.float32)
    st = quantize_rows_int4(torch.from_numpy(X))
    q_i8, _, q_off = quantize_query(torch.from_numpy(
        rng.standard_normal((2, 32)).astype(np.float32)))
    good = _kernel_sums(st.values, q_i8, q_off, int4=True)
    dirty = torch.cat([q_i8, torch.ones((2, 32), dtype=torch.int8)], 1)
    bad = _kernel_sums(st.values, dirty, q_off, int4=True)
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
