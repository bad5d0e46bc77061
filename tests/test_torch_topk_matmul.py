"""Port's fused top-k (instsearch_torch.kernels.topk_matmul) against the JAX
Pallas kernel, run in interpret mode on the CPU as tests/kernels/ runs it.

On the CPU the port's wrapper takes its plain version
(``topk_matmul_reference``); the CUDA kernel itself is held against that
same plain version on the card (tests/test_torch_gpu.py, and chip_smoke.py).

Tolerances: ids must be equal; scores to rtol = atol = 1e-4, because the
two sides sum the f32 products in different orders. Data are random
normals, whose scores are far apart at these sizes, so exact id equality
is a fair demand; where ties are the point, rows are exact duplicates.
"""
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instsearch_tpu.kernels import topk_matmul as jax_topk_matmul
from instsearch_torch.kernels import _build, topk_matmul
from instsearch_torch.kernels.topk_matmul import (check_against_plain,
                                                  topk_matmul_reference)

_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _both(X, Q, k, dtype="float32", tile=None, num_valid=None, mask=None):
    """(jax scores, jax ids, port scores, port ids) as numpy."""
    js, ji = jax_topk_matmul(
        jnp.asarray(X, _JNP[dtype]), jnp.asarray(Q), k=k, tile_n=tile,
        num_valid=num_valid,
        mask=None if mask is None else jnp.asarray(mask), interpret=True)
    xt = torch.from_numpy(X).to(_TORCH[dtype])
    ps, pi = topk_matmul(xt, torch.from_numpy(Q), k=k, num_valid=num_valid,
                         mask=None if mask is None else torch.from_numpy(mask))
    return np.asarray(js), np.asarray(ji), ps.numpy(), pi.numpy()


def _assert_same(js, ji, ps, pi):
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_allclose(ps, js, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,d,b,k,tile", [
    (256, 64, 1, 10, 64),
    (512, 128, 4, 10, 128),
    (1024, 128, 3, 1, 256),      # k=1
    (128, 256, 2, 128, 128),     # k == N == tile_n
    (264, 128, 2, 5, 8),         # N multiple of 8 only
    (1024, 128, 16, 10, 256),    # B = 16: a tensor-core query block
    (512, 64, 128, 10, 128),     # B = 128: query_chunk, one query block
])
def test_matches_pallas_kernel(n, d, b, k, tile, dtype):
    rng = np.random.default_rng(0)
    X = rng.standard_normal((n, d)).astype(np.float32)
    Q = rng.standard_normal((b, d)).astype(np.float32)
    _assert_same(*_both(X, Q, k, dtype, tile))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ties_lowest_position_first(dtype):
    rng = np.random.default_rng(1)
    base = rng.standard_normal((8, 64)).astype(np.float32)
    X = np.concatenate([base] * 8)          # every row duplicated 8x
    Q = rng.standard_normal((2, 64)).astype(np.float32)
    js, ji, ps, pi = _both(X, Q, 16, dtype, tile=16)
    _assert_same(js, ji, ps, pi)
    # each duplicated score appears with ascending positions
    for row_s, row_i in zip(ps, pi):
        for a in range(15):
            if row_s[a] == row_s[a + 1]:
                assert row_i[a] < row_i[a + 1]


def test_num_valid_masks_poisoned_padding():
    rng = np.random.default_rng(2)
    X = rng.standard_normal((256, 64)).astype(np.float32)
    X[200:] = 100.0                          # must never be returned
    Q = rng.standard_normal((2, 64)).astype(np.float32)
    js, ji, ps, pi = _both(X, Q, 10, tile=64, num_valid=200)
    assert pi.max() < 200
    _assert_same(js, ji, ps, pi)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fewer_valid_than_k(dtype):
    rng = np.random.default_rng(3)
    X = rng.standard_normal((64, 32)).astype(np.float32)
    Q = rng.standard_normal((2, 32)).astype(np.float32)
    js, ji, ps, pi = _both(X, Q, 10, dtype, tile=32, num_valid=4)
    np.testing.assert_array_equal(pi, ji)
    assert (pi[:, 4:] == -1).all() and np.isneginf(ps[:, 4:]).all()
    np.testing.assert_allclose(ps[:, :4], js[:, :4], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_subset_mask(dtype):
    rng = np.random.default_rng(4)
    X = rng.standard_normal((256, 64)).astype(np.float32)
    Q = rng.standard_normal((3, 64)).astype(np.float32)
    mask = (rng.random((1, 256)) < 0.5).astype(np.int8)
    js, ji, ps, pi = _both(X, Q, 10, dtype, tile=128, mask=mask)
    _assert_same(js, ji, ps, pi)
    assert mask[0, pi].all()


def test_k_larger_than_store_pads():
    """k > N: the plain version pads with (-inf, -1) as the kernel does."""
    rng = np.random.default_rng(5)
    X = torch.from_numpy(rng.standard_normal((6, 16)).astype(np.float32))
    Q = torch.from_numpy(rng.standard_normal((2, 16)).astype(np.float32))
    s, i = topk_matmul(X, Q, k=9)
    assert s.shape == (2, 9) and (i[:, 6:] == -1).all()
    assert sorted(i[0, :6].tolist()) == list(range(6))


def test_rejects_what_it_cannot_take():
    X = torch.zeros((64, 16))
    Q = torch.zeros((1, 16))
    with pytest.raises(ValueError, match="topk_matmul_int8"):
        topk_matmul(X.to(torch.int8), Q, k=5)        # K2/K3's rows
    with pytest.raises(ValueError):
        topk_matmul(X, Q, k=0)
    with pytest.raises(ValueError):
        topk_matmul(X, torch.zeros((1, 8)), k=5)


def _dup_store():
    """16 copies of 8 base rows: the top 8 are the 8 lowest copies of one
    base row, all scoring the same."""
    rng = np.random.default_rng(6)
    base = rng.standard_normal((8, 64)).astype(np.float32)
    return (torch.from_numpy(np.concatenate([base] * 16)),
            torch.from_numpy(rng.standard_normal((2, 64)).astype(np.float32)),
            8)


def _random_store():
    rng = np.random.default_rng(7)
    return (torch.from_numpy(rng.standard_normal((256, 64)).astype(np.float32)),
            torch.from_numpy(rng.standard_normal((2, 64)).astype(np.float32)),
            10)


def _near_tie_store():
    """Unit rows; rows 0 and 1 differ in one component by 1e-6 and are the
    query's top two, about 3e-7 apart: a near-tie two summation orders may
    flip, yet far above the f32 spacing of scores near 1."""
    rng = np.random.default_rng(8)
    X = rng.standard_normal((64, 32)).astype(np.float32)
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    j = int(np.argmax(np.abs(X[0])))
    X[1] = X[0]
    X[1, j] += 1e-6
    return torch.from_numpy(X), torch.from_numpy(X[:1].copy()), 4


def _swap(t, a, b):
    t[:, [a, b]] = t[:, [b, a]]


def _mut_copies_unordered(s, i):
    _swap(i, 0, 1)


def _mut_later_copy(s, i):
    i[:, 7] += 8                        # copy 8 instead of copy 7


def _mut_repeat(s, i):
    i[0, 2] = i[0, 0]


def _mut_far_swap(s, i):
    _swap(i, 0, 5)


def _mut_score_off(s, i):
    s[0, 0] += 1e-3


def _mut_near_tie_swap(s, i):
    _swap(i, 0, 1)


@pytest.mark.parametrize("store,mutate,message", [
    (_dup_store, None, None),
    (_dup_store, _mut_copies_unordered, "order"),
    (_dup_store, _mut_later_copy, "copies of one row"),
    (_random_store, _mut_repeat, "twice"),
    (_random_store, _mut_far_swap, "beyond a near-tie"),
    (_random_store, _mut_score_off, "scores differ"),
    (_near_tie_store, _mut_near_tie_swap, None),
], ids=["equal", "copies-unordered", "later-copy", "repeat", "far-swap",
        "score-off", "near-tie-swap"])
def test_check_against_plain(store, mutate, message):
    """The rule the CUDA kernel is held to on the card: it accepts the
    plain version's own answer and a flipped near-tie of distinct rows, and
    rejects a wrong tie order among copies, a repeated position, a swap
    beyond a near-tie and a score off by more than the tolerance."""
    X, Q, k = store()
    rs, ri = topk_matmul_reference(X, Q, k=k)
    s, i = rs.clone(), ri.clone()
    if mutate is not None:
        mutate(s, i)
    if message is None:
        assert check_against_plain(X, Q, s, i, rs, ri, 1e-5) <= 1e-5
    else:
        with pytest.raises(AssertionError, match=message):
            check_against_plain(X, Q, s, i, rs, ri, 1e-5)


def test_check_against_plain_empty_slots():
    X, Q, _ = _random_store()
    rs, ri = topk_matmul_reference(X[:6], Q, k=9)
    s, i = rs.clone(), ri.clone()
    i[0, 8] = 3
    with pytest.raises(AssertionError, match="empty"):
        check_against_plain(X[:6], Q, s, i, rs, ri, 1e-5)


def test_cpu_path_loads_no_library():
    """The module imports and serves CPU tensors without nvcc: the CUDA
    library is built and loaded only at a CUDA launch."""
    topk_matmul(torch.zeros((16, 8)), torch.zeros((1, 8)), k=3)
    assert _build._lib is None
    assert "jax" not in topk_matmul.__module__
    assert "instsearch_torch.kernels.topk_matmul" in sys.modules
