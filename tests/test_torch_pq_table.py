"""K4's lookup table (instsearch_torch.kernels.pq_scan._lut / pq_table)
against the JAX reference's ``instsearch_tpu.ops.pq.pq_lut`` rounded to
bf16, and an emulation of the shared-memory layout in which the card's pass
1 keeps a query block's table (csrc/pq_scan.cu, ``PqTable``).

Tolerance of the table against JAX. The port fixes each dot product's order
(one f32 product, then one f32 addition of each next product, no fused
multiply-add); the reference's einsum sums in XLA's order. The two f32 sums
differ by a few f32 ulps at most, and the bf16 entries are equal except
where a bf16 rounding midpoint lies between the two f32 sums: there they
are one bf16 step apart. The test requires exactly that of every entry that
differs, and that such entries are rare.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instsearch_tpu.ops.pq import PQCodebook as JaxCodebook
from instsearch_tpu.ops.pq import pq_lut as jax_pq_lut
from instsearch_torch.kernels.pq_scan import _lut, pq_table
from instsearch_torch.ops.pq import PQCodebook

CODES = 16


def _inputs(seed, b, d, m):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    cent = (0.25 * rng.standard_normal((m, CODES, d // m))).astype(np.float32)
    return q, cent


def _fixed_order_f32(q, cent):
    """The f32 sums of ``_lut`` before the bf16 rounding, in numpy."""
    b, m, ds = q.shape[0], cent.shape[0], cent.shape[2]
    qs = q.reshape(b, m, 1, ds)
    acc = qs[..., 0] * cent[..., 0]
    for t in range(1, ds):
        acc = (acc + qs[..., t] * cent[..., t]).astype(np.float32)
    return acc


def _bf16(x):
    return torch.tensor(x).to(torch.bfloat16).float().numpy()


@pytest.mark.parametrize("seed,b,d,m", [(0, 3, 64, 8), (1, 5, 96, 12),
                                        (2, 4, 512, 64), (3, 2, 2048, 256)])
def test_table_equals_jax_pq_lut_in_bf16_but_at_midpoints(seed, b, d, m):
    q, cent = _inputs(seed, b, d, m)
    jax_f32 = np.asarray(jax_pq_lut(jnp.asarray(q), JaxCodebook(
        jnp.asarray(cent))), np.float32)
    want = _bf16(jax_f32)
    got = _lut(torch.tensor(q), PQCodebook(torch.tensor(cent)), m // 2).numpy()
    ours_f32 = _fixed_order_f32(q, cent)
    assert np.array_equal(got, _bf16(ours_f32))
    np.testing.assert_allclose(ours_f32, jax_f32, rtol=0,
                               atol=8 * np.finfo(np.float32).eps)
    diff = got != want
    assert diff.mean() < 1e-2
    bits = lambda v: torch.tensor(v).bfloat16().view(torch.int16).numpy()
    assert (np.abs(bits(got[diff]).astype(np.int32)
                   - bits(want[diff]).astype(np.int32)) == 1).all()
    assert (np.sign(got[diff]) == np.sign(want[diff])).all()
    mid = (got[diff].astype(np.float64) + want[diff]) / 2   # the midpoint
    lo = np.minimum(ours_f32[diff], jax_f32[diff])
    hi = np.maximum(ours_f32[diff], jax_f32[diff])
    assert ((lo <= mid) & (mid <= hi)).all()


@pytest.mark.parametrize("d,m,groups", [(64, 8, 4), (96, 12, 8),
                                        (96, 12, 12), (512, 64, 32)])
def test_pq_table_on_the_cpu_is_the_plain_table(d, m, groups):
    """``pq_table`` takes ``_lut`` on the CPU; padded G (M = 12 -> G = 8)
    gets zero rows for the padding bytes' nibbles."""
    q, cent = _inputs(d + groups, 3, d, m)
    cb = PQCodebook(torch.tensor(cent))
    before = pq_table.launches
    got = pq_table(torch.tensor(q), cb, groups)
    assert pq_table.launches == before
    assert got.shape == (3, 2 * groups, CODES) and got.dtype == torch.float32
    assert torch.equal(got, _lut(torch.tensor(q), cb, groups))
    half = m // 2
    plain = _lut(torch.tensor(q), cb, half)
    assert torch.equal(got[:, :half], plain[:, :half])
    assert torch.equal(got[:, groups:groups + half], plain[:, half:])
    assert not got[:, half:groups].any()
    assert not got[:, groups + half:].any()
    if groups == half:
        assert torch.equal(pq_table(torch.tensor(q), cb), got)


def test_pq_table_refuses_a_width_it_cannot_take():
    q, cent = _inputs(0, 2, 64, 8)
    cb = PQCodebook(torch.tensor(cent))
    with pytest.raises(ValueError):
        pq_table(torch.tensor(q[:, :32]), cb)
    with pytest.raises(ValueError):
        pq_table(torch.tensor(q), cb, groups=3)


# ---- the card's shared-memory layout (csrc/pq_scan.cu, PqTable<QB>) ------

def _layout(qb):
    """(words a (row, slot), words a load, loads a (row, slot))."""
    words = qb // 2 if qb >= 2 else 1
    vec_words = 2 if qb >= 4 else 1
    return words, vec_words, words // vec_words


def _index(r, s, jp, qb):
    """PqTable<QB>::index: the 32-bit word offset of word jp of (table row
    r, slot s) in the block's table: [row][load v][slot][word of the
    load]."""
    words, vw, _ = _layout(qb)
    return (r * CODES * words + (jp // vw) * CODES * vw + s * vw + jp % vw)


def _bits(x):
    return int(np.float32(x).view(np.uint32))


def _stage_block(table, q0, qb, groups):
    """The block's load loop (PqTable::word): word jp of (row r, code c) of
    queries q0 + 2 jp (low half) and q0 + 2 jp + 1 (high half) as bf16, or
    the f32 entry at QB = 1, to slot c (low nibbles' rows) or c ^ 8 (high
    nibbles' rows); zeros past B."""
    b = table.shape[0]
    words = _layout(qb)[0]

    def at(j, r, c):
        return _bits(table[q0 + j, r, c]) if q0 + j < b else 0

    smem = np.full(_layout(qb)[0] * CODES * 2 * groups, 0xDEADBEEF,
                   np.uint64)
    for jp in range(words):
        for r in range(2 * groups):
            for c in range(CODES):
                s = c if r < groups else c ^ 8
                w = (at(0, r, c) if qb == 1 else
                     (at(2 * jp, r, c) >> 16)
                     | (at(2 * jp + 1, r, c) & 0xFFFF0000))
                smem[_index(r, s, jp, qb)] = w
    return smem


def _lookup(smem, qb, r, nib):
    """PqTable::add for table row r and a stored nibble: the QB entries as
    the kernel reads them, load v at byte r * (row bytes) + nib * (load
    bytes) + v * 16 * (load bytes), each word widened to its low and high
    bf16 halves (the f32 word itself at QB = 1)."""
    words, vw, vecs = _layout(qb)
    row = r * CODES * words * 4
    if qb == 1:
        return np.array([smem[row // 4 + nib]], np.uint32).view(np.float32)
    out = []
    for v in range(vecs):
        first = (row + nib * vw * 4 + v * CODES * vw * 4) // 4
        for t in range(vw):
            x = int(smem[first + t])
            out += [(x << 16) & 0xFFFFFFFF, x & 0xFFFF0000]
    return np.array(out, np.uint32).view(np.float32)


@pytest.mark.parametrize("qb", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("b,groups,q0", [(37, 4, 32), (37, 8, 0),
                                         (5, 32, 0)])
def test_query_minor_layout_round_trips(qb, b, groups, q0):
    """Every word of the staged block is written, and the kernel's lookup
    of a stored code byte at group g gives ``table[q0 + j, g, code]`` for
    its low nibble and ``table[q0 + j, groups + g, code]`` for its high one,
    read at the nibble as stored (code ^ 8, ``(byte >> 4) + 8`` of the
    signed byte); zeros for queries past B. The table's values are bf16, as
    the table kernel rounds them, so the halves widen back exactly."""
    rng = np.random.default_rng(qb + 7 * groups)
    table = _bf16(rng.standard_normal((b, 2 * groups, CODES)
                                      ).astype(np.float32))
    smem = _stage_block(table, q0, qb, groups)
    assert (smem != 0xDEADBEEF).all()
    want = np.zeros((qb, 2 * groups, CODES), np.float32)
    n = max(0, min(qb, b - q0))
    want[:n] = table[q0:q0 + n]
    for byte in range(256):
        g = byte % groups
        lo, hi = byte & 15, (byte >> 4) & 15
        assert np.array_equal(_lookup(smem, qb, g, lo), want[:, g, lo])
        assert np.array_equal(_lookup(smem, qb, groups + g, hi),
                              want[:, groups + g, hi ^ 8])


@pytest.mark.parametrize("qb", [1, 2, 4, 8, 16])
def test_a_load_of_any_16_slots_is_one_wavefront(qb):
    """A warp's load of one (table row, load v) for its 32 rows reads at
    most 16 distinct slots. A 4-byte load (QB <= 2) is served for the whole
    warp, an 8-byte one (QB >= 4) by half-warps; a phase takes one 128-byte
    wavefront when no two of its distinct words share a bank. Here the 16
    slots' words of load v lie in one aligned 128-byte line, in distinct
    banks, so every phase is one wavefront whatever the codes. A layout
    with 16-byte loads of slot-major rows ([row][slot][QB]) would not be:
    its quarter-warp phases put slots s and s + 8 on the same banks."""
    words, vw, vecs = _layout(qb)
    for r in (0, 5):
        for v in range(vecs):
            loaded = [_index(r, s, v * vw, qb) + t for s in range(CODES)
                      for t in range(vw)]
            assert len({w * 4 // 128 for w in loaded}) == 1
            assert len({w % 32 for w in loaded}) == CODES * vw
    if qb == 16:                    # the slot-major 16-byte layout
        bank_groups = [(s * words * 4) // 16 % 8 for s in range(CODES)]
        assert bank_groups[0] == bank_groups[8]
