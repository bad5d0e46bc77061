"""The quality tiers on the port's sharded index (``ShardedIndex.
search_diffusion``, ``search_lw``, ``expand_queries(include_query=False)``,
``Index.augment_database(mesh=)``, ``Index.knn_graph(mesh=)`` and the
``search_sharded`` routes) against the port's own single-device Index and
against the JAX package's ``ShardedIndex`` on the eight virtual CPU devices
of tests/conftest.py (``make_mesh(S)``; JAX's ``to_sharded`` takes its
oracle on the CPU).

The store: 440 rows around 4 clusters (each with more members than D = 32)
padded to a capacity of 512, row tile 8: at S = 8 the rows end inside shard
6 and shard 7 is all padding.

Tolerances. Against the port's single device: equal (the same plain
versions and the same merge order). Against JAX: ids equal but at
near-ties, scores within 1e-6 (f32 sums in two orders), diffused scores
within 1e-5 of the row's largest (CG at alpha = 0.99 amplifies the f32
order, test_torch_diffusion.py), local whitening through the reference's
bank (its view carried into the port, test_torch_lw_rerank.py), augmented
stores within one bf16 step.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instsearch_tpu.config import IndexConfig as JaxIndexConfig
from instsearch_tpu.config import PipelineConfig as JaxPipelineConfig
from instsearch_tpu.config import SearchConfig as JaxSearchConfig
from instsearch_tpu.index import Index as JaxIndex
from instsearch_tpu.parallel import make_mesh as jax_mesh
from instsearch_torch import PipelineConfig
from instsearch_torch.index import Index
from instsearch_torch.ops.local_whiten import LocalWhiteningParams
from instsearch_torch.parallel import make_mesh
from instsearch_torch.search.lw_rerank import LocalWhiteningView

N, CAP, D = 440, 512, 32
SHARDS = (2, 8)


def _rows():
    rng = np.random.default_rng(31)
    centres = rng.standard_normal((4, D)).astype(np.float32)
    scale = np.linspace(0.3, 0.7, D).astype(np.float32)
    x = centres[rng.integers(0, 4, N + 6)] / 2 + scale * \
        rng.standard_normal((N + 6, D)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _pair(dtype="bfloat16", **search):
    x = _rows()
    cfg = JaxPipelineConfig(
        index=JaxIndexConfig(dtype=dtype, row_tile=8, capacity=CAP,
                             dba_n=6),
        search=JaxSearchConfig(k=7, qe_n=4, diffusion_depth=40,
                               rerank_depth=30, use_pallas=False, **search))
    names = [f"r{i}" for i in range(N)]
    jidx = JaxIndex.from_descriptors(x[:N], names, cfg)
    tidx = Index.from_descriptors(x[:N], names,
                                  PipelineConfig.from_json(cfg.to_json()),
                                  device="cpu")
    return x[N:], jidx, tidx


def _mesh(s):
    return make_mesh(s, devices=["cpu"] * s)


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _assert_ranked(js, ji, ts, ti, tol):
    js, ji, ts, ti = _np(js), _np(ji), _np(ts), _np(ti)
    np.testing.assert_array_equal(np.isfinite(ts), np.isfinite(js))
    fin = np.isfinite(js)
    np.testing.assert_allclose(ts[fin], js[fin], rtol=0, atol=tol)
    for r in range(ji.shape[0]):
        score = dict(zip(ji[r].tolist(), js[r].tolist()))
        for a, b in zip(ti[r].tolist(), ji[r].tolist()):
            if a != b:
                assert a in score and abs(score[a] - score[b]) < tol, (r, a, b)


def _equal(a, b):
    for u, v in zip(a, b):
        np.testing.assert_array_equal(_np(u), _np(v))


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("dtype", ["bfloat16", "int8", "int4"])
def test_diffusion(dtype, shards):
    q, jidx, tidx = _pair(dtype)
    sidx = tidx.to_sharded(mesh=_mesh(shards))
    scfg = tidx.cfg.search.replace(diffusion_enabled=True, qe_enabled=True)
    for mask in (None, tidx.make_subset(ids=list(range(0, N, 3)))):
        want = tidx.search(q, scfg, subset=mask)
        _equal(tidx.search_sharded(sidx, q, scfg, subset=mask), want)
    got = sidx.search_diffusion(q, k=7, depth=40)
    _equal(got, tidx.search(q, scfg.replace(qe_enabled=False)))
    js, ji = jidx.to_sharded(mesh=jax_mesh(shards)).search_diffusion(
        jidx._match_query_dim(jnp.asarray(q)), k=7, depth=40)
    scale = max(1.0, float(np.abs(_np(js)[np.isfinite(_np(js))]).max()))
    _assert_ranked(js, ji, *got, 1e-5 * scale)


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("dtype", ["bfloat16", "int8", "int4"])
def test_local_whitening(dtype, shards):
    q, jidx, tidx = _pair(dtype, qe_enabled=True)
    jidx.fit_local_whitening(n_clusters=4)
    p = jidx.lw.params
    tidx.lw = LocalWhiteningView(
        LocalWhiteningParams(*(torch.tensor(np.asarray(t))
                               for t in (p.centroids, p.P, p.mu))),
        torch.tensor(np.asarray(jidx.lw.store.astype(jnp.float32)))
        .to(torch.bfloat16), torch.tensor(np.asarray(jidx.lw.assign)))
    tidx.cfg = tidx.cfg.replace(search=tidx.cfg.search.replace(
        lw_enabled=True))
    sidx = tidx.to_sharded(mesh=_mesh(shards))
    for mask in (None, tidx.make_subset(ids=list(range(0, N, 3)))):
        _equal(tidx.search_sharded(sidx, q, subset=mask),
               tidx.search(q, subset=mask))
    got = sidx.search_lw(q, k=7, depth=30)
    _equal(got, tidx.search(q, tidx.cfg.search.replace(qe_enabled=False)))
    js, ji = jidx.to_sharded(mesh=jax_mesh(shards)).search_lw(
        jidx._match_query_dim(jnp.asarray(q)), k=7, depth=30)
    _assert_ranked(js, ji, *got, 1e-6)
    with pytest.raises(ValueError, match="no local-whitening view"):
        Index.from_descriptors(_rows()[:N], tidx.names, tidx.cfg,
                               device="cpu").to_sharded(
            mesh=_mesh(shards)).search_lw(q)


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("dtype", ["bfloat16", "int8", "int4"])
def test_database_side_expansion(dtype, shards):
    q, jidx, tidx = _pair(dtype)
    rows = tidx._rows_f32_chunk(0, 64)
    got = tidx.to_sharded(mesh=_mesh(shards)).expand_queries(
        rows, qe_n=6, include_query=False)
    want = jidx.to_sharded(mesh=jax_mesh(shards)).expand_queries(
        jidx._rows_f32_chunk(0, 64), qe_n=6, include_query=False)
    np.testing.assert_allclose(got[:, :D].numpy(), np.asarray(want)[:, :D],
                               atol=1e-6)


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("dtype", ["bfloat16", "int8", "int4"])
def test_augment_database_through_the_mesh(dtype, shards):
    q, jidx, tidx = _pair(dtype)
    one = Index.from_descriptors(_rows()[:N], tidx.names, tidx.cfg,
                                 device="cpu")
    one.augment_database()
    tidx.augment_database(mesh=_mesh(shards))
    assert torch.equal(tidx.descriptors, one.descriptors)
    if dtype != "bfloat16":
        assert torch.equal(tidx.scales, one.scales)
    jidx.augment_database(mesh=jax_mesh(shards))
    a = tidx._rows_f32_chunk(0, CAP).numpy()
    b = np.asarray(jidx._rows_f32_chunk(0, CAP))
    if dtype == "bfloat16":
        assert (np.abs(a - b) <= np.abs(b) * 2.0 ** -7 + 1e-7).all()
    else:
        step = np.asarray(jidx.scales).reshape(-1, 1) * 1.0001 + 1e-9
        assert (np.abs(a - b) < step).all()


@pytest.mark.parametrize("shards", SHARDS)
def test_knn_graph_through_the_mesh(shards):
    _, jidx, tidx = _pair("int8")
    subset = list(range(0, N, 2))
    for sub in (None, subset):
        want = tidx.knn_graph(k=5, chunk=64, subset=sub)
        got = tidx.knn_graph(k=5, chunk=64, subset=sub, mesh=_mesh(shards))
        _equal(got, want)
        js, ji = jidx.knn_graph(k=5, chunk=64, subset=sub,
                                mesh=jax_mesh(shards))
        _assert_ranked(js, ji, *got, 1e-6)
    pairs = tidx.find_duplicates(tau=0.8, k=5, mesh=_mesh(shards))
    _equal(pairs, tidx.find_duplicates(tau=0.8, k=5))
