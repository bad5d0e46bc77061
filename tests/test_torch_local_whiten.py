"""Local (per-cluster) whitening (``instsearch_torch/ops/local_whiten.py``)
against ``instsearch_tpu/ops/local_whiten.py`` on the same seeded rows.

The fixtures keep N > D within every cluster's blend: 4 clusters of ~160
rows at D = 32, so the global covariance each cluster blends toward has
full rank and no eigenvalue under ``eps`` is amplified by ``rsqrt``.

What is compared, and the tolerances:
  * the moments of each cluster (``cluster_moments``, rows sorted by
    cluster and walked in pieces, against the reference's masked outer
    products of the same pieces): 1e-5 of their largest entry;
  * the bank, through what it scores. The sign of each eigenvector and the
    basis of a repeated eigenvalue are each library's choice (LAPACK
    through JAX in f32, ``torch.linalg.eigh`` in f64 here), so ``P`` is not
    compared element by element: ``P_e^T P_e`` (the metric of expert e)
    within 1e-4 of its largest entry, ``mu`` within 1e-6, and the products
    of rows whitened by the same expert (what re-ranking scores) within
    1e-5;
  * the router's centroids within 1e-6 (test_torch_kmeans.py), routing
    equal (well-separated clusters);
  * ``tau`` -> infinity gives every expert the global whitening: equal to
    ``ops/whitening.py::fit_whitening`` of the same rows through its
    scores.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instsearch_tpu.ops import local_whiten as jl
from instsearch_torch.ops import local_whiten as tl
from instsearch_torch.ops.whitening import apply_whitening, fit_whitening

D, E = 32, 4


def _rows(seed=0, n=640):
    rng = np.random.default_rng(seed)
    centres = rng.standard_normal((E, D)).astype(np.float32)
    centres /= np.linalg.norm(centres, axis=1, keepdims=True)
    scale = np.linspace(0.2, 0.6, D).astype(np.float32)   # anisotropic
    x = (centres[rng.integers(0, E, n)]
         + scale * rng.standard_normal((n, D)).astype(np.float32))
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _metric(P):
    P = np.asarray(P, np.float64)
    return np.einsum("eod,eof->edf", P, P)


@pytest.mark.parametrize("chunk", [100, 640])
def test_cluster_moments_match_the_reference_pieces(chunk):
    x = _rows()
    assign = np.random.default_rng(1).integers(0, E, len(x)).astype(np.int32)
    order = np.argsort(assign, kind="stable")
    xs, asort = x[order], assign[order]
    want_o = np.zeros((E, D, D), np.float32)
    want_s = np.zeros((E, D), np.float32)
    want_c = np.zeros((E,), np.float32)
    for c0 in range(0, len(x), chunk):
        xc = np.zeros((chunk, D), np.float32)
        ac = np.full((chunk,), -1, np.int32)
        part = slice(c0, c0 + chunk)
        xc[:len(xs[part])], ac[:len(xs[part])] = xs[part], asort[part]
        eids = np.unique(ac[ac >= 0])
        eids = np.concatenate([eids, np.full((8 - len(eids),), -1)])
        o, s, c = jl._chunk_moments(jnp.asarray(xc), jnp.asarray(ac),
                                    jnp.asarray(eids, jnp.int32), m=8)
        live = eids >= 0
        want_o[eids[live]] += np.asarray(o)[live]
        want_s[eids[live]] += np.asarray(s)[live]
        want_c[eids[live]] += np.asarray(c)[live]
    o, s, c = tl.cluster_moments(torch.as_tensor(x), torch.as_tensor(assign),
                                 E, chunk=chunk)
    for got, want in ((o, want_o), (s, want_s), (c, want_c)):
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("tau,dim", [(64.0, None), (0.0, 24), (8.0, 16)])
def test_fit_matches_jax_through_scores(tau, dim):
    x = _rows()
    want = jl.fit_local_whitening(jnp.asarray(x), E, dim=dim, tau=tau, seed=0)
    got = tl.fit_local_whitening(torch.as_tensor(x), E, dim=dim, tau=tau,
                                 seed=0)
    np.testing.assert_allclose(got.centroids.numpy(),
                               np.asarray(want.centroids), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.mu.numpy(), np.asarray(want.mu), rtol=0,
                               atol=1e-6)
    assert tuple(got.P.shape) == tuple(want.P.shape)
    mj, mt = _metric(want.P), _metric(got.P.numpy())
    np.testing.assert_allclose(mt, mj, rtol=0, atol=1e-4 * np.abs(mj).max())
    xj = jnp.asarray(x[:64])
    route = tl.route(torch.as_tensor(x[:64]), got).numpy()
    np.testing.assert_array_equal(route, np.asarray(jl.route(xj, want)))
    oj = np.asarray(jl.apply_local_whitening(xj, want))
    ot = tl.apply_local_whitening(torch.as_tensor(x[:64]), got).numpy()
    # rows whitened by one expert (what re-ranking compares); across two
    # experts the product depends on both experts' eigenvector signs
    same = route[:, None] == route[None, :]
    np.testing.assert_allclose((ot @ ot.T)[same], (oj @ oj.T)[same], rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(ot, axis=1), 1.0, atol=1e-6)


def test_bank_from_the_reference_moments(monkeypatch):
    """``bank_from_moments`` on the reference's own moments (its k-means
    and chunk pass) gives the reference's bank, through the metric; the
    eigh calls in pieces of 3 clusters."""
    monkeypatch.setattr(tl, "BANK_PIECE", 3)
    x = _rows(seed=2)
    cent, assign = jl.fit_kmeans(jnp.asarray(x), E, seed=0)
    a = np.asarray(assign)
    o, s, c = tl.cluster_moments(torch.as_tensor(x), torch.as_tensor(a), E)
    P, mu = tl.bank_from_moments(o, s, c, dim=D, tau=64.0)
    want = jl.fit_local_whitening(jnp.asarray(x), E, tau=64.0, seed=0)
    np.testing.assert_allclose(mu.numpy(), np.asarray(want.mu), atol=1e-6)
    mj = _metric(want.P)
    np.testing.assert_allclose(_metric(P.numpy()), mj, rtol=0,
                               atol=1e-4 * np.abs(mj).max())


def test_infinite_tau_is_the_global_whitening():
    x = torch.as_tensor(_rows(seed=3))
    lw = tl.fit_local_whitening(x, E, tau=float("inf"), seed=0)
    glob = fit_whitening(x)
    want = apply_whitening(x[:50], glob)
    got = tl.apply_local_whitening(x[:50], lw)
    torch.testing.assert_close(got @ got.T, want @ want.T, rtol=0, atol=1e-5)
    for e in range(E):
        torch.testing.assert_close(lw.mu[e], glob.mu, rtol=0, atol=1e-6)


def test_project_by_expert_equals_the_gathered_product():
    """One product per expert present equals the reference's gathered
    ``einsum('bd,bod->bo', x - mu[a], P[a])``; ids outside the bank give
    zero rows."""
    x = torch.as_tensor(_rows(seed=4)[:40])
    lw = tl.fit_local_whitening(x, E, seed=0)
    a = tl.route(x, lw)
    want = torch.einsum("bd,bod->bo", x - lw.mu[a], lw.P[a])
    torch.testing.assert_close(tl.project_by_expert(x, a, lw.P, lw.mu), want,
                               rtol=0, atol=1e-6)
    out = tl.project_by_expert(x, a - 2, lw.P[2:], lw.mu[2:])
    keep = (a >= 2) & (a < 4)
    torch.testing.assert_close(out[keep], want[keep], rtol=0, atol=1e-6)
    assert bool((out[~keep] == 0).all())
