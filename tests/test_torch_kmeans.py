"""Spherical k-means (``instsearch_torch/ops/kmeans.py``) against
``instsearch_tpu/ops/kmeans.py`` on the same seeded numpy rows.

The assignment argmaxes bf16 products summed in f32, so a row whose two
best centroids score within a few f32 ulps may go either way between the
libraries and change everything after it. The fixtures are rows around
well-separated centres, where no such near-tie exists: assignments and
counts must be EQUAL, and the centroids (normalized f32 sums of the same
bf16 rows in another order) within 1e-6. The initial rows and the
respawns come from ``numpy.random.default_rng(seed)`` in both packages,
so a fit from the same seed is the same fit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instsearch_tpu.ops import kmeans as jk
from instsearch_torch.ops import kmeans as tk


def _blobs(seed=0, c=6, per=50, d=32, spread=0.15):
    rng = np.random.default_rng(seed)
    centres = rng.standard_normal((c, d)).astype(np.float32)
    centres /= np.linalg.norm(centres, axis=1, keepdims=True)
    x = (np.repeat(centres, per, axis=0)
         + spread * rng.standard_normal((c * per, d)).astype(np.float32))
    x = x[rng.permutation(len(x))]
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def test_pick_chunk_matches_jax():
    for n, want in ((1000, 16384), (1000, 300), (65536, 16384), (97, 10)):
        assert tk.pick_chunk(n, want) == jk.pick_chunk(n, want)


@pytest.mark.parametrize("nv", [300, 288])
def test_assign_clusters_matches_jax(nv):
    """Rows past ``num_valid`` come back -1."""
    x = _blobs()
    cent = x[:6] + 0.01
    want = jk.assign_clusters(jnp.asarray(x), jnp.asarray(cent), nv,
                              chunk=60)
    got = tk.assign_clusters(torch.as_tensor(x), torch.as_tensor(cent), nv,
                             chunk=64)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got[nv:] == -1).all()


def test_lloyd_iter_matches_jax():
    x = _blobs()
    cent = jk._l2n(jnp.asarray(x[:6]))
    jc, jn, js = jk._lloyd_iter(jnp.asarray(x), cent, 290, n_clusters=6,
                                chunk=60)
    tc, tn, ts = tk.lloyd_iter(torch.as_tensor(x), torch.as_tensor(
        np.asarray(cent)), 290, chunk=100)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=1e-6)
    assert abs(float(ts) - float(js)) < 1e-6


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("n_clusters", [6, 9])
def test_fit_kmeans_matches_jax(n_clusters, seed):
    """Nine clusters over six blobs leave some empty: the respawns draw
    from the same generator in both packages."""
    x = _blobs(seed=seed)
    jc, ja = jk.fit_kmeans(jnp.asarray(x), n_clusters, iters=6, seed=seed,
                           chunk=60)
    tc, ta = tk.fit_kmeans(torch.as_tensor(x), n_clusters, iters=6,
                           seed=seed, chunk=128)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(tc.numpy(), axis=1), 1.0,
                               atol=1e-6)


def test_fit_kmeans_refuses_fewer_rows_than_clusters():
    with pytest.raises(ValueError, match="clusters"):
        tk.fit_kmeans(torch.zeros(4, 8), 5)
