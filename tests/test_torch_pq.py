"""ops/pq.py of the port against the JAX package's on the same seeded numpy
inputs: packing, decoding, lookup tables, encoding, the Lloyd fit and OPQ.

Tolerances, and why:
  * ``unpack_pq``, ``decode_pq``, ``default_m``: equal (integer arithmetic
    and a gather).
  * ``pq_lut``: 1e-6 absolute, f32 dot products of ds=8 components summed
    in another order.
  * ``encode_pq`` with shared centroids: codes equal, except in rows where
    the two best distances of some subspace lie within 1e-6 of each other
    (both sides take bf16 products summed in f32, in another order).
  * ``fit_pq``: both draw the initial rows and the respawns from
    ``numpy.random.default_rng(seed)``; centroids within 1e-4 after one
    Lloyd iteration (the f32 means of the same bf16 rows), reconstruction
    MSE within 1% after 15. The fit sample keeps every cluster under 256
    rows per slice, where the reference's bf16 per-slice counts are exact.
  * ``fit_opq``: rotation within 1e-4 after one alternation (one f32 SVD
    each side); after three, reconstruction MSE within 1% of JAX's and no
    higher than plain PQ's.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instsearch_tpu.ops import pq as jpq
from instsearch_torch.ops import pq as tpq


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _anisotropic(rng, n, d, decay=0.9):
    z = rng.standard_normal((n, d)).astype(np.float32)
    spec = (decay ** np.arange(d)).astype(np.float32)
    basis, _ = np.linalg.qr(rng.standard_normal((d, d)))
    x = (z * spec) @ basis.astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _codebooks(rng, m, ds):
    cent = rng.standard_normal((m, 16, ds)).astype(np.float32)
    return jpq.PQCodebook(jnp.asarray(cent)), tpq.PQCodebook(
        torch.from_numpy(cent.copy()))


@pytest.mark.parametrize("m", [2, 8, 64])
def test_unpack_and_decode_equal(rng, m):
    packed = rng.integers(-128, 128, size=(300, m // 2)).astype(np.int8)
    jcb, tcb = _codebooks(rng, m, 4)
    np.testing.assert_array_equal(
        tpq.unpack_pq(torch.from_numpy(packed)).numpy(),
        np.asarray(jpq.unpack_pq(jnp.asarray(packed))))
    np.testing.assert_array_equal(
        tpq.decode_pq(torch.from_numpy(packed), tcb).numpy(),
        np.asarray(jpq.decode_pq(jnp.asarray(packed), jcb)))


@pytest.mark.parametrize("d", [8, 16, 32, 56, 64, 100, 128, 512, 2048])
def test_default_m_equal(d):
    assert tpq.default_m(d) == jpq.default_m(d)


def test_dim_checks_raise_alike(rng):
    x = _unit(rng, 64, 24)
    for m in (3, 5):                           # odd, and not dividing 24
        with pytest.raises(ValueError) as jerr:
            jpq.fit_pq(jnp.asarray(x), m=m)
        with pytest.raises(ValueError) as terr:
            tpq.fit_pq(torch.from_numpy(x), m=m)
        assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("m,d", [(8, 64), (64, 512)])
def test_pq_lut_equal(rng, m, d):
    q = _unit(rng, 5, d)
    jcb, tcb = _codebooks(rng, m, d // m)
    np.testing.assert_allclose(
        tpq.pq_lut(torch.from_numpy(q), tcb).numpy(),
        np.asarray(jpq.pq_lut(jnp.asarray(q), jcb)), rtol=0, atol=1e-6)


def _near_tie_rows(x, cent, tol=1e-6):
    """Rows where some subspace's two best distances (bf16 operands, as both
    encoders take them) lie within tol."""
    bf = lambda a: torch.tensor(a).to(torch.bfloat16).double().numpy()
    m, _, ds = cent.shape
    xs = bf(x).reshape(len(x), m, ds)
    c = bf(cent)
    cn2 = (cent.astype(np.float64) ** 2).sum(-1)
    dist = cn2[None] - 2.0 * np.einsum("nmd,mkd->nmk", xs, c)
    two = np.sort(dist, axis=2)[:, :, :2]
    return (two[:, :, 1] - two[:, :, 0] < tol).any(axis=1)


@pytest.mark.parametrize("m", [4, 8])
def test_encode_equal_with_shared_centroids(rng, m):
    x = _unit(rng, 1024, 32)
    jcb, tcb = _codebooks(rng, m, 32 // m)
    want = np.asarray(jpq.encode_pq(jnp.asarray(x), jcb, chunk=256))
    got = tpq.encode_pq(torch.from_numpy(x), tcb, chunk=256).numpy()
    differ = (got != want).any(axis=1)
    assert not (differ & ~_near_tie_rows(x, np.asarray(jcb.centroids))).any()
    assert differ.mean() < 0.01


def test_fit_one_iteration_equal_and_fifteen_close(rng):
    x = _unit(rng, 1024, 64)
    one_j = jpq.fit_pq(jnp.asarray(x), m=8, iters=1, seed=3)
    one_t = tpq.fit_pq(torch.from_numpy(x), m=8, iters=1, seed=3)
    np.testing.assert_allclose(one_t.centroids.numpy(),
                               np.asarray(one_j.centroids), rtol=0,
                               atol=1e-4)
    j15 = jpq.fit_pq(jnp.asarray(x), m=8, iters=15, seed=3)
    t15 = tpq.fit_pq(torch.from_numpy(x), m=8, iters=15, seed=3)
    mse_j = jpq.pq_reconstruction_mse(jnp.asarray(x), j15)
    mse_t = tpq.pq_reconstruction_mse(torch.from_numpy(x), t15)
    assert mse_t == pytest.approx(mse_j, rel=0.01)
    assert mse_t < tpq.pq_reconstruction_mse(torch.from_numpy(x), one_t)


def test_fit_ignores_padding_rows(rng):
    x = _unit(rng, 256, 32)
    x[200:] = 100.0                           # padding past num_valid
    cb = tpq.fit_pq(torch.from_numpy(x), m=4, iters=4, num_valid=200)
    assert float(cb.centroids.abs().max()) < 2.0


def test_opq_rotation_close_and_mse_not_higher(rng):
    """One alternation: the rotations within 1e-4 (measured 5.6e-5). Later
    rounds encode under the slightly different rotation, flip near-tie
    codes and drift apart (3 rounds: 4.6e-2), so three rounds are held by
    their reconstruction MSE instead: within 1% of JAX's, and no higher
    than plain PQ's."""
    x = _anisotropic(rng, 1024, 32)
    xt = torch.from_numpy(x)
    jr, _ = jpq.fit_opq(jnp.asarray(x), m=4, opq_iters=1, pq_iters=6, seed=1)
    tr, _ = tpq.fit_opq(xt, m=4, opq_iters=1, pq_iters=6, seed=1)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=0, atol=1e-4)
    jr, jcb = jpq.fit_opq(jnp.asarray(x), m=4, opq_iters=3, pq_iters=6,
                          seed=1)
    tr, tcb = tpq.fit_opq(xt, m=4, opq_iters=3, pq_iters=6, seed=1)
    np.testing.assert_allclose((tr.T @ tr).numpy(), np.eye(32), rtol=0,
                               atol=1e-4)
    plain = tpq.fit_pq(xt, m=4, iters=6, seed=1)
    mse = tpq.pq_reconstruction_mse(xt, tcb, rotation=tr)
    assert mse <= tpq.pq_reconstruction_mse(xt, plain)
    assert mse == pytest.approx(
        jpq.pq_reconstruction_mse(jnp.asarray(x), jcb, rotation=jr),
        rel=0.01)

