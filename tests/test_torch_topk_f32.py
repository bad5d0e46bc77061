"""K1 over an f32 store on the card: the split-TF32 arithmetic of its pass 1
(``instsearch_torch/csrc/topk_wgmma.cuh``, ``WgF32``), emulated on the CPU
as the kernel forms it, against the plain version and against the JAX
Pallas kernel run in interpret mode (as tests/kernels/test_topk_matmul.py
runs it). The selection that follows the scores is held bit for bit in
tests/test_torch_topk_select.py; the kernel itself on the card in
tests/test_torch_gpu.py and chip_smoke.py.

What the emulation does, step for step: rows padded with zeros to tiles of
128 and chunks of 32 columns (TMA's zero fill past N and D); each chunk
laid out as TMA's 128-byte swizzle lays it; each k8 step's A fragment
gathered from the lane addresses of the kernel's ``ldmatrix`` and placed by
the TF32 wgmma fragment layout; each value split into ``hi = rna(v)`` and
``lo = rna(v - hi)`` (``cvt.rna.tf32.f32``: 10 stored mantissa bits, to
nearest, ties away from zero); the query split the same way into its two
planes (zero past D); per k8 step and row tile three products, x_lo q_hi,
x_hi q_lo, x_hi q_hi, each an exact 8-term sum added to an f32 accumulator
(the card's tensor cores add in their own order; the model is exact
products rounded once into the running f32 sum).

Tolerances. Against the plain version's f32 sums on unit rows: SCORE_TOL
(1e-5, the card's rule), the split being within ~3 * 2^-24 of each product.
On integer rows of up to 23 significant bits (phase 15a's SIFT-shaped rows
and their l2 norm column): none, the sums are exact. Against the JAX
kernel: ids equal but at near-ties below SCORE_TOL (``check_against_plain``
with the JAX answer as the reference).

Every test runs with one intra-op thread (the suite's workers share the
cores).
"""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instsearch_tpu.kernels import topk_matmul as jax_topk_matmul
from instsearch_torch.kernels.topk_matmul import (check_against_plain,
                                                  topk_matmul,
                                                  topk_matmul_reference)
from instsearch_torch.search.bruteforce import masked_scores, select_topk

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from chip_smoke import SCORE_TOL  # noqa: E402

TILE = 128          # rows a stage (kWgRows)
COLS = 32           # f32 columns a 128-byte chunk (WgF32::kChunkCols)

# the A fragment of one warpgroup's k8 step: warp v, lane l, register i
_V, _L, _I = torch.meshgrid(torch.arange(4), torch.arange(32),
                            torch.arange(4), indexing="ij")
# ldmatrix.x4: register i of lane l holds 4 bytes (one f32) at byte 4 (l %
# 4) of row l // 4 of matrix i, whose rows' addresses lanes 8 i .. 8 i + 7
# give: lane p the row 16 v + p % 16, 16-byte half p // 16 of the k8 step,
# at chunk (2 kk + half) ^ (p % 8)
_P = 8 * _I + _L // 4
# the TF32 A fragment: register i of lane l holds row 16 v + l / 4 (+ 8 for
# i odd), column l % 4 (+ 4 for i >= 2)
_M = 16 * _V + _L // 4 + 8 * (_I % 2)
_K = _L % 4 + 4 * (_I // 2)


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


def rna(v: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: f32 to TF32 (10 stored mantissa bits), to
    nearest with ties away from zero, as f32 with the 13 low bits zero (on
    the sign-magnitude bits, adding half a TF32 step rounds the magnitude
    half up)."""
    bits = v.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0x1000) & 0xFFFFE000
    signed = torch.where(bits >= 1 << 31, bits - (1 << 32), bits)
    return signed.to(torch.int32).view(torch.float32)


def split(v: torch.Tensor):
    """(hi, lo): the kernel's two TF32 parts of f32 values."""
    hi = rna(v)
    return hi, rna(v - hi)


def _swizzled(tile: torch.Tensor) -> torch.Tensor:
    """A [128, 32] f32 stage as TMA's 128-byte swizzle lays it out: 16-byte
    chunk j of row r at chunk j ^ (r % 8)."""
    r = torch.arange(tile.shape[0])[:, None]
    j = torch.arange(8)[None, :]
    return tile.reshape(-1, 8, 4)[r, j ^ (r % 8)].reshape(tile.shape)


def _a_fragment(stage: torch.Tensor, kk: int, rt: int) -> torch.Tensor:
    """The f32 each lane's ldmatrix.x4 gets at k8 step kk of row tile rt
    from the swizzled stage ([128, 32] f32): [4 warps, 32 lanes, 4]."""
    row = 64 * rt + 16 * _V + _P % 16
    chunk = (2 * kk + _P // 16) ^ (_P % 8)          # the kernel's address
    return stage[row, 4 * chunk + _L % 4]


def _a_matrix(regs: torch.Tensor) -> torch.Tensor:
    """The 64 x 8 A operand that TF32 wgmma reads from the fragments'
    registers."""
    a = torch.zeros((64, 8), dtype=regs.dtype)
    a[_M, _K] = regs
    return a


def kernel_scores(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """[B, N] f32 scores as the card's pass 1 forms them (see above)."""
    n, d = x.shape
    b = q.shape[0]
    chunks = -(-d // COLS)
    tiles = -(-n // TILE)
    rows = torch.zeros((tiles * TILE, chunks * COLS))
    rows[:n, :d] = x
    qpad = torch.zeros((b, chunks * COLS))
    qpad[:, :d] = q
    q_hi, q_lo = (p.double() for p in split(qpad))
    acc = torch.zeros((b, tiles * TILE), dtype=torch.float32)
    for t in range(tiles):
        for c in range(chunks):
            stage = _swizzled(rows[t * TILE:(t + 1) * TILE,
                                   c * COLS:(c + 1) * COLS])
            for kk in range(4):
                ks = slice(c * COLS + 8 * kk, c * COLS + 8 * kk + 8)
                for rt in range(2):
                    a = _a_matrix(_a_fragment(stage, kk, rt))
                    a_hi, a_lo = (p.double() for p in split(a))
                    cols = slice(t * TILE + 64 * rt, t * TILE + 64 * rt + 64)
                    for aa, qq in ((a_lo, q_hi), (a_hi, q_lo), (a_hi, q_hi)):
                        acc[:, cols] = (acc[:, cols].double()
                                        + qq[:, ks] @ aa.T).float()
    return acc[:, :n]


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return torch.from_numpy(x / np.linalg.norm(x, axis=1, keepdims=True))


def sift_like(rng, n: int, d: int = 128):
    """Phase 15a's store in small (``chip_smoke.sift_like_rows``): integer
    rows ``round(128 u^2)`` with the l2 norm column ``0.5 |x|^2`` and
    integer queries near rows (+-3) with -1 on that column, padded with
    zero columns to 136 as the Index pads them."""
    u = rng.random((n, d))
    rows = np.round(128.0 * u * u)
    x = np.zeros((n, 136), np.float32)
    x[:, :d] = rows
    x[:, d] = 0.5 * (rows * rows).sum(1)
    src = rng.choice(n, size=5, replace=False)
    q = np.zeros((5, 136), np.float32)
    q[:, :d] = rows[src] + rng.integers(-3, 4, (5, d))
    q[:, d] = -1.0
    return torch.from_numpy(x), torch.from_numpy(q), src


def test_rna_rounds_to_nearest_ties_away_from_zero():
    """``rna``: 10 stored mantissa bits; a tie (the dropped 13 bits exactly
    0x1000) rounds away from zero for either sign, never to even."""
    one = 1.0
    step = 2.0 ** -10
    v = torch.tensor([one + step / 2, one + 3 * step / 2, -(one + step / 2),
                      one + step / 2 - 2.0 ** -23, 3.0, -0.0],
                     dtype=torch.float32)
    want = torch.tensor([one + step, one + 2 * step, -(one + step), one,
                         3.0, -0.0], dtype=torch.float32)
    got = rna(v)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert bool(((got.view(torch.int32) & 0x1FFF) == 0).all())


def test_fragment_gather_reads_the_stage_in_order():
    """The lane addresses of the kernel's ldmatrix (chunk (2 kk + half) ^
    (lane % 8) of row 16 v + lane % 16) on an f32 stage TMA swizzled,
    placed by the TF32 A fragment layout, give each k8 step's 64 x 8
    columns of both row tiles as the rows hold them."""
    tile = torch.arange(128 * 32, dtype=torch.float32).view(128, 32)
    stage = _swizzled(tile)
    assert not torch.equal(stage, tile)
    for kk in range(4):
        for rt in range(2):
            got = _a_matrix(_a_fragment(stage, kk, rt))
            assert torch.equal(got, tile[64 * rt:64 * rt + 64,
                                         8 * kk:8 * kk + 8])


@pytest.mark.parametrize("d", [8, 96, 136, 512, 2048])
def test_split_arithmetic_matches_plain_version(d):
    """The card's scores (``kernel_scores``) against the plain version's
    f32 sums within SCORE_TOL on unit rows: D = 8 fills a quarter of one
    chunk, 96 three chunks, 136 ends inside its fifth (phase 15a's store),
    2048 sixty-four; 300 rows end inside a tile. The split's own error,
    against f64 sums, stays far under the bar."""
    rng = np.random.default_rng(d)
    x = _unit(rng, 300, d)
    q = _unit(rng, 3, d)
    got = kernel_scores(x, q)
    plain = masked_scores(x, q)
    assert float((got - plain).abs().max()) < SCORE_TOL
    exact = q.double() @ x.double().T
    assert float((got.double() - exact).abs().max()) < SCORE_TOL / 10


def test_one_part_alone_is_not_enough():
    """What the three products buy: x_hi q_hi alone (plain TF32) misses
    the plain version by more than SCORE_TOL."""
    rng = np.random.default_rng(5)
    x = _unit(rng, 300, 512)
    q = _unit(rng, 3, 512)
    tf32 = rna(q).double() @ rna(x).double().T
    assert float((tf32 - masked_scores(x, q).double()).abs().max()) > \
        SCORE_TOL


@pytest.mark.parametrize("d", [96, 136, 512])
def test_split_arithmetic_ranks_as_pallas_kernel(d):
    """The card's scores, ranked (score desc, position asc, as the
    selection ranks them), against the interpret-mode Pallas kernel's
    top-k: ids equal but at near-ties, scores within SCORE_TOL, copies of a
    row in position order."""
    rng = np.random.default_rng(2 * d)
    X = _unit(rng, 384, d).numpy()
    X[150:170] = X[20]
    Q = _unit(rng, 3, d).numpy()
    js, ji = jax_topk_matmul(jnp.asarray(X), jnp.asarray(Q), k=40,
                             tile_n=128, interpret=True)
    x, q = torch.from_numpy(X), torch.from_numpy(Q)
    s, i = select_topk(kernel_scores(x, q), 40)
    check_against_plain(x, q, s, i, torch.from_numpy(np.array(js)),
                        torch.from_numpy(np.array(ji)), SCORE_TOL)
    # and the port's wrapper on the CPU (its plain version) ranks the same
    ws, wi = topk_matmul(x, q, k=40)
    check_against_plain(x, q, s, i, ws, wi, SCORE_TOL)


def test_integer_rows_sum_exactly():
    """Phase 15a's SIFT-shaped integer rows with their norm column: every
    part is exact (the components in hi alone, the norm column, a
    half-integer near 2^17, in hi + lo, and the query's -1 in hi), so the
    card's scores equal the exact f64 sums bit for bit and rank as the
    plain version, whose f32 sums are exact too."""
    rng = np.random.default_rng(15)
    x, q, src = sift_like(rng, 700)
    norms = x[:, 128]
    assert float(norms.max()) < 2 ** 22
    hi, lo = split(norms)
    assert torch.equal(hi.double() + lo.double(), norms.double())
    got = kernel_scores(x, q)
    exact = q.double() @ x.double().T
    assert torch.equal(got.double(), exact)
    s, i = select_topk(got, 10)
    rs, ri = topk_matmul_reference(x, q, 10)
    assert torch.equal(i, ri) and torch.equal(s, rs)
    assert (i[:, 0].numpy() == src).all()


def test_the_edge_of_exactness():
    """hi + lo carries a value exactly when its significand has at most 23
    bits (the remainder after rounding hi to nearest needs at most 11):
    every integer below 2^23 and half-integer below 2^22 sampled, and any
    23-bit significand at any scale, split exactly; past that a value may
    not, and a norm column there moves the kernel's score: 0.5 |x|^2 =
    2^22 + 2047.5 (|x|^2 = 2^23 + 4095, 24 bits) splits to 2^22 + 2048,
    half a unit off, where the plain version's f32 FMA keeps it."""
    rng = np.random.default_rng(23)
    ints = torch.from_numpy(np.concatenate([
        rng.integers(0, 2 ** 23, 20000), np.arange(2 ** 23 - 4096, 2 ** 23),
        np.arange(2 ** 22 - 4096, 2 ** 22 + 4096)]).astype(np.float32))
    halves = torch.from_numpy(np.concatenate([
        rng.integers(0, 2 ** 23, 20000),
        np.arange(2 ** 23 - 8192, 2 ** 23)]).astype(np.float64) / 2).float()
    sig23 = torch.from_numpy(np.ldexp(
        rng.integers(2 ** 22, 2 ** 23, 20000).astype(np.float64),
        rng.integers(-40, 40, 20000)).astype(np.float32))
    for v in (ints, halves, sig23):
        hi, lo = split(v)
        assert torch.equal(hi.double() + lo.double(), v.double())
    edge = torch.tensor([2.0 ** 22 + 2047.5], dtype=torch.float32)
    assert float(edge) == 2.0 ** 22 + 2047.5            # exact in f32
    hi, lo = split(edge)
    assert float(hi.double() + lo.double()) == 2.0 ** 22 + 2048
    # a row whose norm column lies there, against a query with -1 on it
    x = torch.zeros((1, 136))
    x[0, 128] = edge
    q = torch.zeros((1, 136))
    q[0, 0], q[0, 128] = 1.0, -1.0
    x[0, 0] = 3.0
    got = float(kernel_scores(x, q)[0, 0])
    assert float(masked_scores(x, q)[0, 0]) == 3.0 - (2.0 ** 22 + 2047.5)
    assert got == 3.0 - (2.0 ** 22 + 2048)
