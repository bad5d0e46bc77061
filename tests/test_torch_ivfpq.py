"""The IVF-PQ tier (``instsearch_torch/search/ivfpq.py``,
``Index.build_ivfpq``) and the host row store against ``instsearch_tpu``'s
on the same seeded rows.

The store: 600 clustered unit rows (16 centres, D = 64) in a capacity of 640,
C = 16 clusters, m = 8 subspaces. One module fixture builds the JAX index
and its view (without and with OPQ) once and saves the view. Tolerances:
  * ``_adc_select``: the port gathers the table by the codes where the
    reference sums a one-hot einsum, the same function in another order of
    f32 sums: scores within 1e-5 of the row's largest |ADC score|,
    positions equal but at near-ties below that bar;
  * the cascade re-scores exactly in f32: scores within 1e-6, ids equal but
    at near-ties (from the ADC selection at the depth boundary);
  * own fits: the coarse assignments equal, the residual codebook within
    1e-5 after one Lloyd iteration, recall@10 within 0.02 of JAX's after
    the default iterations (as ``fit_pq`` was held);
  * the host store's files are byte-equal both ways; ``search_host``
    re-scores in numpy as the reference, so over the same candidates its
    answers are equal.
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instsearch_tpu.config import IndexConfig as JaxIndexConfig
from instsearch_tpu.config import PipelineConfig as JaxPipelineConfig
from instsearch_tpu.config import SearchConfig as JaxSearchConfig
from instsearch_tpu.index import Index as JaxIndex
from instsearch_tpu.search import ivfpq as jivfpq
from instsearch_torch import PipelineConfig
from instsearch_torch.index import Index, attach_regional_store
from instsearch_torch.search import ivfpq as tivfpq

N, CAP, D, C, M = 600, 640, 64, 16, 8
ADC_TOL = 1e-5
TOL = 1e-6


def _clustered(seed, n, d, centres=16, noise=0.15):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((centres, d)).astype(np.float32)
    a /= np.linalg.norm(a, axis=1, keepdims=True)
    x = a[rng.integers(0, centres, n)] + noise * rng.standard_normal(
        (n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _queries(x, seed=3, n=12, noise=0.1):
    rng = np.random.default_rng(seed)
    q = x[rng.choice(len(x), n, replace=False)]
    q = q + noise * rng.standard_normal(q.shape).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def _cfg(dtype="float32", capacity=CAP, row_tile=64, **search):
    return JaxPipelineConfig(
        index=JaxIndexConfig(dtype=dtype, row_tile=row_tile,
                             capacity=capacity),
        search=JaxSearchConfig(k=10, use_pallas=False, **search))


def _pair(x, dtype="float32", **kw):
    cfg = _cfg(dtype, **kw)
    names = [f"r{i}" for i in range(len(x))]
    return (JaxIndex.from_descriptors(x, names, cfg),
            Index.from_descriptors(x, names,
                                   PipelineConfig.from_json(cfg.to_json()),
                                   device="cpu"))


def _carry(jview, tmp):
    jview.save(str(tmp))
    return tivfpq.IVFPQView.load(str(tmp), device="cpu")


def _attach(tidx, view):
    tidx.ivfpq = view
    tidx.cfg = tidx.cfg.replace(
        search=tidx.cfg.search.replace(ivfpq_nprobe=view.nprobe))


def _near_tie_ids(ts, ti, js, ji, tol):
    """ids equal, but where two rows' scores lie within ``tol``."""
    for r, c in zip(*np.nonzero(ti != ji)):
        other = np.flatnonzero(ji[r] == ti[r, c])
        if len(other):
            assert abs(float(js[r, other[0]]) - float(js[r, c])) <= 2 * tol
        else:
            assert abs(float(ts[r, c]) - float(js[r, -1])) <= 2 * tol


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """The rows and, without and with OPQ, the JAX index with its IVF-PQ
    view (nprobe 4, depth 64, cap_factor 0.75 so a spill exists) and the
    port's index with the JAX view carried in."""
    x = _clustered(0, N, D)
    out = {"x": x}
    for opq in (0, 2):
        jidx, tidx = _pair(x)
        jv = jidx.build_ivfpq(n_clusters=C, nprobe=4, m=M, pq_iters=6,
                              depth=64, cap_factor=0.75, opq_iters=opq)
        _attach(tidx, _carry(jv, tmp_path_factory.mktemp(f"opq{opq}")))
        out[opq] = (jidx, tidx)
    return out


@pytest.mark.parametrize("opq", [0, 2])
def test_adc_select_against_jax(built, opq):
    jidx, tidx = built[opq]
    jv, tv = jidx.ivfpq, tidx.ivfpq
    assert int((tv.spill_pos >= 0).sum()) > 0
    q = _queries(built["x"])
    mask = np.zeros((1, CAP), np.int8)
    mask[0, ::2] = 1
    for nprobe, depth, m in ((4, 64, None), (C, 700, None), (2, 20, mask)):
        js, jp = jivfpq._adc_select_jit(
            jv.centroids, jv.codes, jv.bucket_pos, jv.spill_codes,
            jv.spill_pos, jv.spill_cluster, jv.codebook.centroids,
            jnp.asarray(q), jv.rotation,
            None if m is None else jnp.asarray(m), depth=depth,
            nprobe=nprobe)
        ts, tp = tivfpq._adc_select(
            *tv.arrays, torch.tensor(q),
            None if m is None else torch.tensor(m), depth=depth,
            nprobe=nprobe)
        js, jp = np.asarray(js), np.asarray(jp)
        ts, tp = ts.numpy(), tp.numpy()
        assert ts.shape == js.shape
        tol = ADC_TOL * np.abs(js[np.isfinite(js)]).max()
        fin = np.isfinite(js)
        np.testing.assert_array_equal(np.isfinite(ts), fin)
        np.testing.assert_allclose(ts[fin], js[fin], rtol=0, atol=tol)
        _near_tie_ids(ts, tp, js, jp, tol)
        if m is not None:
            assert (mask[0][tp[tp >= 0]] == 1).all()


def test_adc_gather_never_expands_one_hot():
    """The gathered sum equals the reference's one-hot einsum on random
    codes (every nibble value, a spill block of many rows)."""
    rng = np.random.default_rng(9)
    codes = rng.integers(-128, 128, size=(3, 50, 4)).astype(np.int8)
    lut = rng.standard_normal((3, 8, 16)).astype(np.float32)
    got = tivfpq._adc_sum(torch.tensor(lut).reshape(3, -1),
                          torch.tensor(codes)).numpy()
    want = np.stack([np.asarray(jivfpq._adc_block(jnp.asarray(codes[b]),
                                                  jnp.asarray(lut[b:b + 1])))
                     for b in range(3)])[:, 0]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    block = tivfpq._adc_block(torch.tensor(codes[0]),
                              torch.tensor(lut).reshape(3, -1)).numpy()
    np.testing.assert_allclose(
        block, np.asarray(jivfpq._adc_block(jnp.asarray(codes[0]),
                                            jnp.asarray(lut))),
        rtol=0, atol=1e-5)


@pytest.mark.parametrize("opq", [0, 2])
def test_cascade_against_jax(built, opq):
    jidx, tidx = built[opq]
    q = _queries(built["x"])
    for nprobe in (1, 4):
        scfg = dict(ivfpq_nprobe=nprobe)
        js, ji = jidx.search(q, jidx.cfg.search.replace(**scfg))
        ts, ti = tidx.search(q, tidx.cfg.search.replace(**scfg))
        np.testing.assert_allclose(ts, js, rtol=0, atol=TOL)
        _near_tie_ids(ts, ti, js, ji, TOL)
    js, ji = jidx.ivfpq.search(jidx, q, k=10)
    ts, ti = tidx.ivfpq.search(tidx, q, k=10)
    _near_tie_ids(ts, ti, js, ji, TOL)
    assert tidx.stats()["ivfpq"] == jidx.stats()["ivfpq"]


def test_composites_qe_and_rerank(built):
    jidx, tidx = built[0]
    x = built["x"]
    q = _queries(x)
    qe = dict(qe_enabled=True, qe_n=3)
    js, ji = jidx.search(q, jidx.cfg.search.replace(**qe))
    ts, ti = tidx.search(q, tidx.cfg.search.replace(**qe))
    np.testing.assert_allclose(ts, js, rtol=0, atol=TOL)
    _near_tie_ids(ts, ti, js, ji, TOL)

    rng = np.random.default_rng(4)
    reg = rng.standard_normal((N, 3, D)).astype(np.float32)
    reg /= np.linalg.norm(reg, axis=2, keepdims=True)
    qreg = rng.standard_normal((len(q), 3, D)).astype(np.float32)
    twin_j = JaxIndex(jidx.descriptors, jidx.ids, jidx.names, jidx.cfg,
                      regional=jnp.asarray(np.pad(
                          reg, ((0, CAP - N), (0, 0), (0, 0)))))
    twin_j.ivfpq = jidx.ivfpq
    twin_t = tidx.with_search()
    attach_regional_store(twin_t, reg)
    rr = dict(rerank_enabled=True, rerank_depth=30, **qe)
    js, ji = twin_j.search(q, twin_j.cfg.search.replace(**rr),
                           query_regional=qreg)
    ts, ti = twin_t.search(q, twin_t.cfg.search.replace(**rr),
                           query_regional=qreg)
    np.testing.assert_allclose(ts, js, rtol=0, atol=1e-5)
    _near_tie_ids(ts, ti, js, ji, 1e-5)


@pytest.mark.parametrize("dtype", ["float32", "int4"])
def test_full_probe_full_depth_is_exact(dtype):
    """nprobe = C and depth >= the rows: every row is a candidate and the
    exact re-score gives the exact route's answer (with αQE too)."""
    x = _clustered(2, 256, 32, centres=8)
    q = _queries(x, n=7, noise=0.3)
    _, idx = _pair(x, dtype, capacity=0, row_tile=8)
    v = idx.build_ivfpq(n_clusters=8, nprobe=8, m=4, depth=256,
                        cap_factor=0.75)
    assert int((v.spill_pos >= 0).sum()) > 0
    for qe in (False, True):
        scfg = idx.cfg.search.replace(qe_enabled=qe, qe_n=3)
        s, i = idx.search(q, scfg)
        es, ei = idx.search(q, scfg.replace(ivfpq_nprobe=0))
        np.testing.assert_array_equal(i, ei)
        np.testing.assert_allclose(s, es, rtol=0, atol=1e-5)


def test_own_fit_against_jax():
    x = _clustered(5, N, D)
    q = _queries(x, n=16, noise=0.05)
    jidx, tidx = _pair(x)
    jv = jidx.build_ivfpq(n_clusters=C, nprobe=4, m=M, pq_iters=1,
                          depth=64)
    tv = tidx.build_ivfpq(n_clusters=C, nprobe=4, m=M, pq_iters=1,
                          depth=64)
    np.testing.assert_allclose(tv.centroids.numpy(), np.asarray(jv.centroids),
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tv.bucket_pos.numpy(),
                                  np.asarray(jv.bucket_pos))
    np.testing.assert_array_equal(tv.spill_cluster.numpy(),
                                  np.asarray(jv.spill_cluster))
    np.testing.assert_allclose(tv.codebook.centroids.numpy(),
                               np.asarray(jv.codebook.centroids), rtol=0,
                               atol=1e-5)
    jidx, tidx = _pair(x)
    jv = jidx.build_ivfpq(n_clusters=C, nprobe=4, m=M, depth=32)
    tv = tidx.build_ivfpq(n_clusters=C, nprobe=4, m=M, depth=32)
    want = jv.measure_recall(jidx, q, k=10)
    got = tv.measure_recall(tidx, q, k=10)
    assert got == pytest.approx(want, abs=0.02)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_absorb_add_remove_reserve(dtype, tmp_path):
    """The same add, remove, spill reservation and add past capacity
    through both packages: positions, clusters and codes of the spill
    equal, answers equal."""
    x = _clustered(6, 730, D)
    jidx, tidx = _pair(x[:500], dtype)
    jv = jidx.build_ivfpq(n_clusters=8, nprobe=3, m=M, pq_iters=4, depth=60)
    _attach(tidx, _carry(jv, tmp_path))
    for idx in (jidx, tidx):
        idx.add(descriptors=x[500:530], names=[f"a{i}" for i in range(30)])
        idx.remove([f"r{i}" for i in range(0, 500, 7)] + ["a3"])
        idx.ivfpq.reserve_spill(100)
        idx.add(descriptors=x[530:730], names=[f"b{i}" for i in range(200)])
    jv, tv = jidx.ivfpq, tidx.ivfpq
    for name in ("bucket_pos", "spill_pos", "spill_cluster", "spill_codes"):
        np.testing.assert_array_equal(getattr(tv, name).numpy(),
                                      np.asarray(getattr(jv, name)))
    q = _queries(x, n=10)
    for nprobe in (3, 8):
        js, ji = jidx.search(q, jidx.cfg.search.replace(ivfpq_nprobe=nprobe))
        ts, ti = tidx.search(q, tidx.cfg.search.replace(ivfpq_nprobe=nprobe))
        np.testing.assert_allclose(ts, js, rtol=0, atol=TOL)
        _near_tie_ids(ts, ti, js, ji, TOL)


def test_save_load_both_ways(tmp_path):
    """An int4 index with its IVF-PQ view (OPQ) at D = 40 saved by each
    package and loaded by the other: the view's arrays equal, the answers
    equal."""
    x = _clustered(7, 200, 40)
    q = _queries(x, n=6)
    jidx, _ = _pair(x, "int4", capacity=0, row_tile=8)
    jidx.build_ivfpq(n_clusters=4, nprobe=2, m=4, pq_iters=3, depth=40,
                     opq_iters=1)
    jidx.save(str(tmp_path / "jax"))
    tidx = Index.load(str(tmp_path / "jax"), device="cpu")
    js, ji = jidx.search(q)
    ts, ti = tidx.search(q)
    np.testing.assert_allclose(ts, js, rtol=0, atol=TOL)
    _near_tie_ids(ts, ti, js, ji, TOL)
    tidx.save(str(tmp_path / "port"))
    back = JaxIndex.load(str(tmp_path / "port"))
    names = ("centroids", "codes", "bucket_pos", "spill_codes", "spill_pos",
             "spill_cluster", "rotation")
    for name in names:
        np.testing.assert_array_equal(np.asarray(getattr(back.ivfpq, name)),
                                      np.asarray(getattr(jidx.ivfpq, name)))
    bs, bi = back.search(q)
    np.testing.assert_array_equal(bi, ji)
    np.testing.assert_array_equal(bs, js)


def _files(path):
    out = {}
    for nm in sorted(os.listdir(path)):
        with open(os.path.join(path, nm), "rb") as f:
            out[nm] = f.read()
    return out


@pytest.mark.parametrize("case", ["int8", "float32", "int8_rows", "ids"])
def test_host_store_files_both_ways(case, tmp_path):
    rng = np.random.default_rng(8)
    x = rng.standard_normal((70, 24)).astype(np.float32)
    kw = {"dtype": "float32" if case == "float32" else "int8"}
    if case == "int8_rows":
        kw["scales"] = rng.random(70).astype(np.float32)
        x = rng.integers(-127, 128, (70, 24)).astype(np.int8)
    if case == "ids":
        kw["ids"] = rng.permutation(1000)[:70]
    j = jivfpq.HostRowStore.create(str(tmp_path / "jax"), x, chunk=32, **kw)
    t = tivfpq.HostRowStore.create(str(tmp_path / "port"), x, chunk=32, **kw)
    assert _files(tmp_path / "jax") == _files(tmp_path / "port")
    back_t = tivfpq.HostRowStore(str(tmp_path / "jax"))
    back_j = jivfpq.HostRowStore(str(tmp_path / "port"))
    pos = rng.integers(-1, 70, (3, 9))
    for a, b in ((back_t, j), (t, back_j)):
        np.testing.assert_array_equal(a.rows_f32(60, 16), b.rows_f32(60, 16))
        np.testing.assert_array_equal(a.gather(pos), b.gather(pos))
        np.testing.assert_array_equal(a.ids_at(pos), b.ids_at(pos))
        np.testing.assert_array_equal(
            a.rows_device(60, 16, device="cpu").numpy(),
            np.asarray(b.rows_device(60, 16)))


def test_host_store_search_against_jax(built, tmp_path):
    """``search_host`` and ``search_adc`` of the carried view over a store
    of the same rows equal JAX's (the same candidates but at ADC near-ties;
    the same numpy re-score); each package's ``from_host_store`` fit over
    the store gives the same layout and codes (but where an assignment
    near-tie flips a code: 99% of the rows)."""
    jidx, tidx = built[0]
    x = built["x"]
    store_rows = np.asarray(jidx.descriptors, np.float32)
    j = jivfpq.HostRowStore.create(str(tmp_path / "st"), store_rows,
                                   dtype="float32")
    t = tivfpq.HostRowStore(str(tmp_path / "st"))
    q = _queries(x)
    js, ji = jidx.ivfpq.search_host(j, q, k=10)
    ts, ti = tidx.ivfpq.search_host(t, q, k=10)
    np.testing.assert_allclose(ts, js, rtol=0, atol=TOL)
    _near_tie_ids(ts, ti, js, ji, TOL)
    ids = np.arange(CAP)[::-1].copy()
    js, ji = jidx.ivfpq.search_adc(q, k=10, ids=ids)
    ts, ti = tidx.ivfpq.search_adc(q, k=10, ids=ids)
    tol = ADC_TOL * np.abs(js).max()
    np.testing.assert_allclose(ts, js, rtol=0, atol=tol)
    _near_tie_ids(ts, ti, js, ji, tol)
    jown = jivfpq.IVFPQView.from_host_store(j, n_clusters=C, m=M,
                                            pq_iters=2, depth=64)
    own = tivfpq.IVFPQView.from_host_store(t, n_clusters=C, m=M, pq_iters=2,
                                           depth=64, device="cpu")
    for name in ("bucket_pos", "spill_pos", "spill_cluster"):
        np.testing.assert_array_equal(getattr(own, name).numpy(),
                                      np.asarray(getattr(jown, name)))
    same = (own.codes.numpy() == np.asarray(jown.codes)).all(axis=-1)
    assert same.mean() >= 0.99
