"""The IVF tier (``instsearch_torch/search/ivf.py`` and ``Index.build_ivf``)
against ``instsearch_tpu``'s on the same seeded rows.

The store: 600 clustered unit rows (16 centres, D = 64) in a capacity of 640
(row tile 64), C = 16 clusters. One module fixture builds the JAX index and
its view once per dtype and saves the view. Tolerances:
  * the JAX view loaded into the port (the same buckets): f32 ids equal and
    scores within 1e-6; bf16 and int8 score the bf16-rounded query, so
    their scores are within 1e-5 and ids equal but at near-ties below it;
  * each package's own fit: the k-means is equal within 1e-6 (PR 15), so
    the bucket layout is equal;
  * full probe equals brute force exactly on f32 rows (ids), with or
    without a spill.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instsearch_tpu.config import IndexConfig as JaxIndexConfig
from instsearch_tpu.config import PipelineConfig as JaxPipelineConfig
from instsearch_tpu.config import SearchConfig as JaxSearchConfig
from instsearch_tpu.index import Index as JaxIndex
from instsearch_tpu.search import ivf as jivf
from instsearch_torch import PipelineConfig
from instsearch_torch.index import Index, attach_regional_store
from instsearch_torch.search import ivf as tivf

N, CAP, D, C = 600, 640, 64, 16
TOL = {"float32": 1e-6, "bfloat16": 1e-5, "int8": 1e-5}
DTYPES = ("float32", "bfloat16", "int8")


def _clustered(seed, n, d, centres=16, noise=0.15):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((centres, d)).astype(np.float32)
    a /= np.linalg.norm(a, axis=1, keepdims=True)
    x = a[rng.integers(0, centres, n)] + noise * rng.standard_normal(
        (n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _cfg(dtype, d=D, **search):
    return JaxPipelineConfig(
        index=JaxIndexConfig(dtype=dtype, row_tile=64, capacity=CAP),
        search=JaxSearchConfig(k=10, use_pallas=False, **search))


def _pair(dtype, x, **search):
    cfg = _cfg(dtype, **search)
    names = [f"r{i}" for i in range(len(x))]
    jidx = JaxIndex.from_descriptors(x, names, cfg)
    tidx = Index.from_descriptors(x, names,
                                  PipelineConfig.from_json(cfg.to_json()),
                                  device="cpu")
    return jidx, tidx


def _carry(jview, tmp):
    """The reference's view as the port's, through its saved form."""
    jview.save(str(tmp))
    return tivf.IVFIndex.load(str(tmp), device="cpu")


def _queries(x, seed=3, n=12):
    rng = np.random.default_rng(seed)
    q = x[rng.choice(len(x), n, replace=False)]
    q = q + 0.1 * rng.standard_normal(q.shape).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """Per dtype: the rows, the JAX index with its IVF view (nprobe 4), the
    port's index over the same rows with the JAX view carried in."""
    x = _clustered(0, N, D)
    out = {}
    for dtype in DTYPES:
        jidx, tidx = _pair(dtype, x)
        jv = jidx.build_ivf(n_clusters=C, nprobe=4, iters=5)
        tidx.ivf = _carry(jv, tmp_path_factory.mktemp(dtype))
        tidx.cfg = tidx.cfg.replace(
            search=tidx.cfg.search.replace(ivf_nprobe=4))
        out[dtype] = (x, jidx, tidx)
    return out


def _near_tie_ids(ts, ti, js, ji, tol):
    """ids equal, but where two rows' scores lie within ``tol`` (a near-tie
    that two orders of f32 sums may flip; at the last slot, a row swapped
    for one just as good)."""
    for r, c in zip(*np.nonzero(ti != ji)):
        other = np.flatnonzero(ji[r] == ti[r, c])
        if len(other):
            assert abs(float(js[r, other[0]]) - float(js[r, c])) <= 2 * tol
        else:
            assert abs(float(ts[r, c]) - float(js[r, -1])) <= 2 * tol


@pytest.mark.parametrize("cap_factor", [4.0, 0.5, 0.1])
def test_bucket_layout_equal(cap_factor):
    rng = np.random.default_rng(1)
    a = rng.integers(0, 12, size=500).astype(np.int32)
    want = jivf._bucket_layout(a, 470, 12, cap_factor)
    got = tivf._bucket_layout(a, 470, 12, cap_factor)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("dtype", DTYPES)
def test_jax_view_loaded_answers_equal(built, dtype):
    x, jidx, tidx = built[dtype]
    q = _queries(x)
    jv, tv = jidx.ivf, tidx.ivf
    assert tv.buckets.dtype == {"float32": torch.float32,
                                "bfloat16": torch.bfloat16,
                                "int8": torch.int8}[dtype]
    np.testing.assert_array_equal(tv.bucket_pos.numpy(),
                                  np.asarray(jv.bucket_pos))
    for nprobe in (1, 4, C):
        js, jp = jv.candidates(jnp.asarray(q), 10, nprobe=nprobe)
        ts, tp = tv.candidates(q, 10, nprobe=nprobe)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0,
                                   atol=TOL[dtype])
        if dtype == "float32":
            np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        else:
            _near_tie_ids(ts.numpy(), tp.numpy(), np.asarray(js),
                          np.asarray(jp), TOL[dtype])
    js, ji = jidx.search(q)
    ts, ti = tidx.search(q)
    np.testing.assert_allclose(ts, js, rtol=0, atol=TOL[dtype])
    _near_tie_ids(ts, ti, js, ji, TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_own_fit_buckets_equal(built, dtype):
    x, jidx, _ = built[dtype]
    _, tidx = _pair(dtype, x)
    tv = tidx.build_ivf(n_clusters=C, nprobe=4, iters=5)
    jv = jidx.ivf
    assert tidx.cfg.search.ivf_nprobe == 4
    np.testing.assert_allclose(tv.centroids.numpy(), np.asarray(jv.centroids),
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tv.bucket_pos.numpy(),
                                  np.asarray(jv.bucket_pos))
    np.testing.assert_array_equal(tv.spill_pos.numpy(),
                                  np.asarray(jv.spill_pos))
    np.testing.assert_array_equal(tv.buckets.float().numpy(),
                                  np.asarray(jv.buckets, np.float32))
    if dtype == "int8":
        np.testing.assert_array_equal(tv.bucket_scales.numpy(),
                                      np.asarray(jv.bucket_scales))
    s = tidx.stats()["ivf"]
    assert s == jidx.stats()["ivf"]


@pytest.mark.parametrize("cap_factor", [4.0, 0.2])
def test_full_probe_equals_bruteforce(cap_factor):
    x = _clustered(2, 300, 32, centres=4)
    q = _queries(x, n=9)
    cfg = PipelineConfig.from_json(_cfg("float32").to_json())
    idx = Index.from_descriptors(x, [f"r{i}" for i in range(300)], cfg,
                                 device="cpu")
    v = idx.build_ivf(n_clusters=4, nprobe=4, iters=5, cap_factor=cap_factor)
    assert (int((v.spill_pos >= 0).sum()) > 0) == (cap_factor < 1)
    s, ids = v.search(idx, q, k=10, nprobe=4)
    want = np.argsort(-(q @ x.T), axis=1, kind="stable")[:, :10]
    np.testing.assert_array_equal(ids, want)
    es, ei = idx.search(q, idx.cfg.search.replace(ivf_nprobe=0))
    np.testing.assert_array_equal(ids, ei)
    np.testing.assert_allclose(s, es, rtol=0, atol=1e-6)
    assert v.measure_recall(idx, q, k=10, nprobe=4) == 1.0


def test_composites_qe_and_rerank(built):
    """αQE and the regional re-rank (with the spatial vote off) through the
    IVF scan, against the JAX Index over the same view and regions."""
    x, jidx, tidx = built["float32"]
    q = _queries(x)
    qe = dict(qe_enabled=True, qe_n=3)
    js, ji = jidx.search(q, jidx.cfg.search.replace(**qe))
    ts, ti = tidx.search(q, tidx.cfg.search.replace(**qe))
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(ts, js, rtol=0, atol=1e-6)

    rng = np.random.default_rng(4)
    reg = rng.standard_normal((N, 3, D)).astype(np.float32)
    reg /= np.linalg.norm(reg, axis=2, keepdims=True)
    qreg = rng.standard_normal((len(q), 3, D)).astype(np.float32)
    twin_j = JaxIndex(jidx.descriptors, jidx.ids, jidx.names, jidx.cfg,
                      regional=jnp.asarray(np.pad(reg, ((0, CAP - N), (0, 0),
                                                        (0, 0)))))
    twin_j.ivf = jidx.ivf
    twin_t = tidx.with_search()
    attach_regional_store(twin_t, reg)
    rr = dict(rerank_enabled=True, rerank_depth=30, **qe)
    js, ji = twin_j.search(q, twin_j.cfg.search.replace(**rr),
                           query_regional=qreg)
    ts, ti = twin_t.search(q, twin_t.cfg.search.replace(**rr),
                           query_regional=qreg)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(ts, js, rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_subset_mask(built, dtype):
    x, jidx, tidx = built[dtype]
    q = _queries(x)
    members = [f"r{i}" for i in range(0, N, 3)]
    js, ji = jidx.search(q, subset=jidx.make_subset(names=members))
    ts, ti = tidx.search(q, subset=tidx.make_subset(names=members))
    assert set(ti[ti >= 0].tolist()) <= set(range(0, N, 3))
    np.testing.assert_allclose(ts, js, rtol=0, atol=TOL[dtype])
    _near_tie_ids(ts, ti, js, ji, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_absorb_add_remove_reserve(dtype, tmp_path):
    """The same add (in place), remove, spill reservation and add past
    capacity through both packages: the views' positions and spill
    arrays equal, the answers equal."""
    x = _clustered(5, 730, D)
    jidx, tidx = _pair(dtype, x[:500])
    jv = jidx.build_ivf(n_clusters=8, nprobe=3, iters=4)
    tidx.ivf = _carry(jv, tmp_path)
    tidx.cfg = tidx.cfg.replace(search=tidx.cfg.search.replace(ivf_nprobe=3))
    for idx in (jidx, tidx):
        idx.add(descriptors=x[500:530], names=[f"a{i}" for i in range(30)])
        idx.remove([f"r{i}" for i in range(0, 500, 7)] + ["a3"])
        if idx is jidx:                 # the reference takes the index too
            idx.ivf.reserve_spill(100, idx)
        else:
            idx.ivf.reserve_spill(100)
        # past the capacity of 640: the store re-pads
        idx.add(descriptors=x[530:730], names=[f"b{i}" for i in range(200)])
    jv, tv = jidx.ivf, tidx.ivf
    for name in ("bucket_pos", "spill_pos"):
        np.testing.assert_array_equal(getattr(tv, name).numpy(),
                                      np.asarray(getattr(jv, name)))
    np.testing.assert_array_equal(tv.spill.float().numpy(),
                                  np.asarray(jv.spill, np.float32))
    q = _queries(x, n=10)
    for nprobe in (3, 8):
        js, ji = jidx.search(q, jidx.cfg.search.replace(ivf_nprobe=nprobe))
        ts, ti = tidx.search(q, tidx.cfg.search.replace(ivf_nprobe=nprobe))
        np.testing.assert_allclose(ts, js, rtol=0, atol=TOL[dtype])
        _near_tie_ids(ts, ti, js, ji, TOL[dtype])


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_save_load_both_ways(dtype, tmp_path):
    """An index with its IVF view at D = 31 (the port's store carries a zero
    column, its buckets do not) saved by each package and loaded by the
    other: arrays and answers equal."""
    x = _clustered(6, 200, 31)
    q = _queries(x, n=6)
    cfg = JaxPipelineConfig(
        index=JaxIndexConfig(dtype=dtype, row_tile=8),
        search=JaxSearchConfig(k=10, use_pallas=False))
    names = [f"r{i}" for i in range(200)]
    jidx = JaxIndex.from_descriptors(x, names, cfg)
    jidx.build_ivf(n_clusters=4, nprobe=2, iters=3)
    jidx.save(str(tmp_path / "jax"))
    tidx = Index.load(str(tmp_path / "jax"), device="cpu")
    assert tidx.store_dim == 32
    assert tuple(tidx.ivf.buckets.shape[1:]) == (
        jidx.ivf.buckets.shape[1], 31)
    js, ji = jidx.search(q)
    ts, ti = tidx.search(q)
    np.testing.assert_allclose(ts, js, rtol=0, atol=TOL[dtype])
    _near_tie_ids(ts, ti, js, ji, TOL[dtype])

    tidx.save(str(tmp_path / "port"))
    with open(tmp_path / "port" / "ivf" / "ivf.json") as f:
        assert json.load(f)["dtypes"]["buckets"] == dtype
    back = JaxIndex.load(str(tmp_path / "port"))
    for name in ("centroids", "buckets", "bucket_pos", "spill", "spill_pos"):
        np.testing.assert_array_equal(
            np.asarray(getattr(back.ivf, name), np.float32),
            np.asarray(getattr(jidx.ivf, name), np.float32))
    bs, bi = back.search(q)
    np.testing.assert_array_equal(bi, ji)
    np.testing.assert_array_equal(bs, js)


def test_refusals():
    x = _clustered(7, 128, 16)
    cfg = PipelineConfig.from_json(_cfg("int4").to_json())
    idx = Index.from_descriptors(x, [f"r{i}" for i in range(128)], cfg,
                                 device="cpu")
    with pytest.raises(ValueError, match="int4 storage"):
        idx.build_ivf(n_clusters=4)
    f32 = PipelineConfig.from_json(_cfg("float32").to_json())
    a = Index.from_descriptors(x, [f"r{i}" for i in range(128)], f32,
                               device="cpu")
    a.build_ivf(n_clusters=4, nprobe=2)
    with pytest.raises(ValueError, match="mutually exclusive"):
        a.build_ivfpq(n_clusters=4, m=2)
    a.build_pq(m=2, depth=32)
    with pytest.raises(ValueError, match="one candidate-selection tier"):
        a.search(x[:2])
    b = Index.from_descriptors(x, [f"r{i}" for i in range(128)], f32,
                               device="cpu")
    b.build_ivfpq(n_clusters=4, m=2, depth=32)
    for build in (lambda: b.build_ivf(n_clusters=4),
                  lambda: b.build_pq(m=2)):
        with pytest.raises(ValueError, match="mutually exclusive"):
            build()
    b.augment_database(n=2)
    assert b.ivfpq is None and b.search(x[:2])[1].shape == (2, 10)
