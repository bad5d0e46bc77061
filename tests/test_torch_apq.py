"""The anisotropic (score-aware) PQ fit, ``ops/pq.py::fit_apq`` /
``encode_apq``, and the PQ and IVF-PQ views fitted with ``anisotropic_t``,
against ``instsearch_tpu``'s on the same seeded rows.

The reference scans the subspaces with ``lax.scan``; the port loops over
them: the same steps, the f32 sums in another order. So:
  * one sweep (assignment and closed-form update) from the same codebook:
    centroids within 1e-6, codes equal;
  * the whole fit (six sweeps): codes equal on >= 99% of the rows, the
    anisotropic loss no higher than JAX's + 1e-4;
  * the views: the PQ view's codes as the fit's, the IVF-PQ view's layout
    equal, ``anisotropic_t`` saved and loaded both ways, the full-probe,
    full-depth cascade exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instsearch_tpu.config import IndexConfig as JaxIndexConfig
from instsearch_tpu.config import PipelineConfig as JaxPipelineConfig
from instsearch_tpu.config import SearchConfig as JaxSearchConfig
from instsearch_tpu.index import Index as JaxIndex
from instsearch_tpu.ops import pq as jpq
from instsearch_torch import PipelineConfig
from instsearch_torch.index import Index
from instsearch_torch.ops import pq as tpq
from instsearch_torch.search.ivfpq import IVFPQView
from instsearch_torch.search.pq_view import PQView


def _rows(seed, n, d, centres=12, sigma=0.15):
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((centres, d)).astype(np.float32)
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    x = (c[rng.integers(0, centres, n)]
         + sigma * rng.standard_normal((n, d)).astype(np.float32))
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _cfg(dtype="float32"):
    return JaxPipelineConfig(
        index=JaxIndexConfig(dtype=dtype, row_tile=8),
        search=JaxSearchConfig(k=10, use_pallas=False))


def _pair(x, dtype="float32"):
    names = [f"r{i}" for i in range(len(x))]
    cfg = _cfg(dtype)
    return (JaxIndex.from_descriptors(x, names, cfg),
            Index.from_descriptors(x, names,
                                   PipelineConfig.from_json(cfg.to_json()),
                                   device="cpu"))


@pytest.mark.parametrize("t", [0.0, 0.1, 0.3, 0.95])
def test_eta_from_threshold(t):
    assert tpq.eta_from_threshold(t, 512) == jpq.eta_from_threshold(t, 512)


def test_eta_refuses_out_of_range():
    for t in (1.0, -0.1):
        with pytest.raises(ValueError, match="must be in"):
            tpq.eta_from_threshold(t, 512)


@pytest.mark.parametrize("residual", [False, True])
def test_one_sweep_from_the_same_codebook(residual):
    """Prep, the MSE assignment, one anisotropic assignment sweep, one
    update sweep and the loss, from the JAX fit_pq codebook: centroids and
    parallel terms within 1e-6, codes equal."""
    x = _rows(0, 400, 32)
    y = x - x.mean(axis=0) if residual else x
    eta = jpq.eta_from_threshold(0.2, 32)
    cent = np.asarray(jpq.fit_pq(jnp.asarray(y), m=4, iters=3).centroids)
    jp = jpq._apq_prep(jnp.asarray(y), jnp.asarray(x), 4, eta)
    tp = tpq._apq_prep(torch.tensor(y), torch.tensor(x), 4, eta)
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-6)
    zc, zt = np.zeros((4, 400), np.int32), np.zeros((4, 400), np.float32)
    jc, jt = jpq._apq_assign_sweep(*jp[:2], jnp.zeros_like(jp[2]),
                                   jnp.asarray(cent), jnp.asarray(zc),
                                   jnp.asarray(zt), k=16)
    tc, tt = tpq._apq_assign_sweep(*tp[:2], torch.zeros_like(tp[2]),
                                   torch.tensor(cent), torch.tensor(zc),
                                   torch.tensor(zt))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    jc, jt = jpq._apq_assign_sweep(*jp, jnp.asarray(cent), jc, jt, k=16)
    tc, tt = tpq._apq_assign_sweep(*tp, torch.tensor(cent), tc, tt)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=0, atol=1e-6)
    jcent, jt = jpq._apq_update_sweep(*jp, jnp.asarray(cent), jc, jt, k=16)
    tcent, tt = tpq._apq_update_sweep(*tp, torch.tensor(cent), tc, tt)
    np.testing.assert_allclose(tcent.numpy(), np.asarray(jcent), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=0, atol=1e-6)
    assert float(tpq._apq_loss(*tp, tcent, tc)) == pytest.approx(
        float(jpq._apq_loss(*jp, jcent, jc)), abs=1e-6)


def test_empty_cluster_keeps_its_centroid():
    """A cluster no row is assigned to keeps its centroid (the reference's
    singular solve is discarded by its where; the port never solves it)."""
    x = _rows(1, 64, 8)
    tp = tpq._apq_prep(torch.tensor(x), torch.tensor(x), 2, 3.0)
    cent = torch.tensor(np.random.default_rng(2).standard_normal(
        (2, 16, 4)).astype(np.float32))
    codes = torch.zeros((2, 64), dtype=torch.int32)
    new, _ = tpq._apq_update_sweep(*tp, cent, codes,
                                   torch.zeros((2, 64)))
    torch.testing.assert_close(new[:, 1:], cent[:, 1:], rtol=0, atol=0)
    assert torch.isfinite(new).all()


@pytest.mark.parametrize("t", [0.1, 0.2])
def test_fit_and_encode_against_jax(t):
    x = _rows(3, 600, 32)
    jcb = jpq.fit_apq(jnp.asarray(x), m=4, t=t, init_iters=6, seed=1)
    tcb = tpq.fit_apq(torch.tensor(x), m=4, t=t, init_iters=6, seed=1)
    jc = np.asarray(jpq.encode_apq(jnp.asarray(x), jcb, t=t))
    tc = tpq.encode_apq(torch.tensor(x), tcb, t=t).numpy()
    assert (tc == jc).all(axis=1).mean() >= 0.99
    eta = jpq.eta_from_threshold(t, 32)
    jp = jpq._apq_prep(jnp.asarray(x), jnp.asarray(x), 4, eta)
    tp = tpq._apq_prep(torch.tensor(x), torch.tensor(x), 4, eta)
    jl = float(jpq._apq_loss(*jp, jcb.centroids,
                             jnp.asarray(jpq.unpack_pq(jnp.asarray(jc)).T)))
    tl = float(tpq._apq_loss(*tp, tcb.centroids,
                             tpq.unpack_pq(torch.tensor(tc)).T))
    assert tl <= jl + 1e-4


def test_residual_directions_and_num_valid():
    x = _rows(4, 300, 32)
    res = x - x.mean(axis=0)
    jcb = jpq.fit_apq(jnp.asarray(res), m=4, directions=jnp.asarray(x),
                      t=0.2, init_iters=4, num_valid=280, sweeps=2)
    tcb = tpq.fit_apq(torch.tensor(res), m=4, directions=torch.tensor(x),
                      t=0.2, init_iters=4, num_valid=280, sweeps=2)
    np.testing.assert_allclose(tcb.centroids.numpy(),
                               np.asarray(jcb.centroids), rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="directions"):
        tpq.fit_apq(torch.tensor(res), m=4, directions=torch.tensor(x[:10]))
    jc = np.asarray(jpq.encode_apq(jnp.asarray(res), jcb,
                                   directions=jnp.asarray(x), t=0.2,
                                   chunk=64))
    tc = tpq.encode_apq(torch.tensor(res), tcb, directions=torch.tensor(x),
                        t=0.2, chunk=64).numpy()
    assert (tc == jc).all(axis=1).mean() >= 0.99


def test_pq_view_with_anisotropic_t(tmp_path):
    """build_pq(anisotropic_t): the view's codes are encode_apq's of its own
    fit, the cascade at full depth is exact, ``anisotropic_t`` rides the
    saved view both ways and ``absorb_add`` re-encodes under the same
    loss."""
    x = _rows(5, 256, 32)
    q = _rows(6, 5, 32)
    jidx, tidx = _pair(x)
    jv = jidx.build_pq(m=4, depth=256, anisotropic_t=0.2)
    tv = tidx.build_pq(m=4, depth=256, anisotropic_t=0.2)
    assert tv.anisotropic_t == 0.2 and tv.rotation is None
    assert tidx.stats()["pq"]["anisotropic_t"] == 0.2
    same = (tv.codes.numpy() == np.asarray(jv.codes)).all(axis=1)
    assert same.mean() >= 0.99
    s, ids = tv.search(tidx, q, k=10, depth=256)
    np.testing.assert_array_equal(ids, np.argsort(-(q @ x.T), axis=1)[:, :10])
    jv.save(str(tmp_path / "j"))
    assert PQView.load(str(tmp_path / "j"), device="cpu").anisotropic_t == 0.2
    tv.save(str(tmp_path / "t"))
    from instsearch_tpu.search.pq_view import PQView as JaxPQView
    assert JaxPQView.load(str(tmp_path / "t")).anisotropic_t == 0.2
    before = tv.packed.clone()
    tv.absorb_add(tidx, 0, 3)
    torch.testing.assert_close(tv.packed, before, rtol=0, atol=0)
    with pytest.raises(ValueError, match="mutually exclusive"):
        tidx.build_pq(m=4, opq_iters=2, anisotropic_t=0.2)


def test_ivfpq_view_with_anisotropic_t(tmp_path):
    """build_ivfpq(anisotropic_t): the layout equals JAX's, residual codes
    on >= 99% of the rows, the full-probe, full-depth cascade is exact, and
    the threshold rides the saved view."""
    x = _rows(7, 256, 32)
    q = _rows(8, 5, 32)
    jidx, tidx = _pair(x)
    kw = dict(n_clusters=8, nprobe=8, m=4, depth=256, anisotropic_t=0.2)
    jv = jidx.build_ivfpq(**kw)
    tv = tidx.build_ivfpq(**kw)
    np.testing.assert_array_equal(tv.bucket_pos.numpy(),
                                  np.asarray(jv.bucket_pos))
    same = (tv.codes.numpy() == np.asarray(jv.codes)).all(axis=-1)
    live = tv.bucket_pos.numpy() >= 0
    assert same[live].mean() >= 0.99
    s, ids = tv.search(tidx, q, k=10, depth=256, nprobe=8)
    np.testing.assert_array_equal(ids, np.argsort(-(q @ x.T), axis=1)[:, :10])
    tv.save(str(tmp_path / "v"))
    assert IVFPQView.load(str(tmp_path / "v"),
                          device="cpu").anisotropic_t == 0.2
    with pytest.raises(ValueError, match="mutually exclusive"):
        _pair(x)[1].build_ivfpq(n_clusters=4, m=4, opq_iters=2,
                                anisotropic_t=0.2)
