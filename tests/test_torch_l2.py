"""The Euclidean metric (``IndexConfig.metric="l2"``, the FAISS
``IndexFlatL2`` counterpart) of the port against the JAX Index on the same
seeded raw rows, mirroring tests/unit/test_l2_metric.py.

An l2 store carries one ``||x||^2/2`` column at column ``dim - 1`` (the
port's zero columns come after it: D = 24 is 25 columns, padded to 32) and
queries gain a ``-1`` there, so the unchanged inner-product kernels rank by
distance; scores come back as ``-||x - q||^2``.

What is compared, and the tolerances:
  * search on the oracle route (f32, bf16, int8) against the JAX Index (its
    oracle on the CPU): ids equal; scores within 1e-5 relative (the norm
    column and ``||q||^2`` are f32 sums in another order) plus 1e-4; f32 ids
    also against a float64 distance oracle;
  * the kernel route (the plain versions of K1/K2 on a CPU store) against
    the reference's ``_topk_jit(use_pallas=True)`` with its Pallas kernels
    in interpret mode: ids equal, scores as above; int8 also bit for bit,
    K2's plain version against the interpret-mode ``topk_matmul_int8`` on
    the port's own augmented rows (``check_exact``);
  * int8 + l2 against the distance oracle by the reference test's own
    bounds (the top-1 survives, the score within 40);
  * ``search_range`` by radius (on the kernel route an int8 store's
    members are K2's, which quantizes the query: counts equal, members
    within one unit of the radius), ``knn_graph``, ``find_duplicates``,
    ``reconstruct``, ``stats``, ``add`` (in place and past capacity),
    ``merge_from`` and ``save``/``load`` both ways against JAX's; the
    sharded view against one device; the refusals.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import instsearch_tpu.kernels as jax_kernels
from instsearch_tpu import ExtractConfig as JaxExtractConfig
from instsearch_tpu import IndexConfig as JaxIndexConfig
from instsearch_tpu import PipelineConfig as JaxPipelineConfig
from instsearch_tpu import SearchConfig as JaxSearchConfig
from instsearch_tpu.index import Index as JaxIndex
from instsearch_tpu.index import _topk_jit
from instsearch_torch import (ExtractConfig, IndexConfig, PipelineConfig,
                              SearchConfig)
from instsearch_torch.index import Index
from instsearch_torch.kernels import topk_matmul_int8
from instsearch_torch.kernels.topk_matmul import check_exact
from instsearch_torch.parallel import make_mesh

N, CAPACITY = 200, 256
RTOL, ATOL = 1e-5, 1e-4
DTYPES = ("float32", "bfloat16", "int8")


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """The suite runs in several worker processes on a few cores: this
    module's small CPU tensors take one intra-op thread, restored
    afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rand(rng, n, d, scale=3.0):
    # NOT unit rows: where the ip and l2 rankings differ
    return (scale * rng.standard_normal((n, d))).astype(np.float32)


def _l2sq(q, x):
    q, x = q.astype(np.float64), x.astype(np.float64)
    return ((q[:, None, :] - x[None, :, :]) ** 2).sum(-1)


def _cfgs(dtype="float32", capacity=CAPACITY, k=5, use_pallas=True):
    icfg = dict(dtype=dtype, row_tile=8, metric="l2", capacity=capacity)
    scfg = dict(k=k, use_pallas=use_pallas, query_chunk=32)
    return (JaxPipelineConfig(extract=JaxExtractConfig(dtype="float32"),
                              index=JaxIndexConfig(**icfg),
                              search=JaxSearchConfig(**scfg)),
            PipelineConfig(extract=ExtractConfig(dtype="float32"),
                           index=IndexConfig(**icfg),
                           search=SearchConfig(**scfg)))


def _pair(x, dtype="float32", names=None, **kw):
    names = names or [f"im{i}" for i in range(len(x))]
    jcfg, tcfg = _cfgs(dtype, **kw)
    return (JaxIndex.from_descriptors(x, names, jcfg),
            Index.from_descriptors(x, names, tcfg, device="cpu"))


@functools.lru_cache(maxsize=None)
def _data(d: int, seed: int = 0):
    rng = np.random.default_rng(500 + d + seed)
    return _rand(rng, N, d), _rand(rng, 6, d)


def _assert_close(got, want):
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("dtype", DTYPES)
def test_search_matches_jax_on_the_oracle_route(dtype):
    x, q = _data(24)
    jidx, tidx = _pair(x, dtype)
    assert tidx.dim == jidx.dim == 25 and tidx.store_dim == 32
    js, ji = jidx.search(q)
    ts, ti = tidx.with_search(use_pallas=False).search(q)
    np.testing.assert_array_equal(ti, np.asarray(ji))
    _assert_close(ts, js)
    if dtype == "float32":
        d2 = _l2sq(q, x)
        np.testing.assert_array_equal(
            ti, np.argsort(d2, axis=1, kind="stable")[:, :5])
        np.testing.assert_allclose(ts, -np.sort(d2, axis=1)[:, :5],
                                   rtol=1e-4, atol=1e-3)
        # the trick does real work: the ip ranking of these rows differs
        assert (ti != np.argsort(-(q @ x.T), axis=1)[:, :5]).any()


@pytest.mark.parametrize("dtype", DTYPES)
def test_kernel_route_matches_jax_kernels(dtype, monkeypatch):
    """D = 31: the augmented rows are 32 wide in both packages."""
    x, q = _data(31)
    jidx, tidx = _pair(x, dtype)
    name = {"float32": "topk_matmul", "bfloat16": "topk_matmul",
            "int8": "topk_matmul_int8"}[dtype]
    monkeypatch.setattr(jax_kernels, name, functools.partial(
        getattr(jax_kernels, name), interpret=True))
    qa = np.concatenate([q, -np.ones((len(q), 1), np.float32)], 1)
    js, ji = _topk_jit(jidx.descriptors, jidx.ids, jnp.asarray(qa),
                       jnp.asarray(jidx.num_valid, jnp.int32), jidx.scales,
                       k=5, use_pallas=True)
    qn2 = (q * q).sum(1)
    want = np.where(np.asarray(ji) >= 0, 2.0 * np.asarray(js)
                    - qn2[:, None], -np.inf)
    ts, ti = tidx.search(q)
    np.testing.assert_array_equal(ti, np.asarray(ji))
    _assert_close(ts, want)
    if dtype == "int8":
        # K2's plain version against the interpret-mode kernel, bit for
        # bit, on the port's own augmented rows and the augmented query
        q_t = tidx._match_query_dim(torch.from_numpy(q))
        got = topk_matmul_int8(tidx.descriptors, tidx.scales, q_t, k=10,
                               num_valid=N)
        ref = jax_kernels.topk_matmul_int8(
            jnp.asarray(tidx.descriptors.numpy()),
            jnp.asarray(tidx.scales.numpy()), jnp.asarray(q_t.numpy()),
            k=10, tile_n=128, num_valid=N, interpret=True)
        check_exact(*got, torch.tensor(np.asarray(ref[0])),
                    torch.tensor(np.asarray(ref[1])))


def test_search_int8_close(rng):
    """The reference test's bounds: the norm column dominates an int8 row's
    scale, so near-ties may flip, but the top-1 (distance ~0) survives and
    the scores stay -L2^2-shaped within the quantization band."""
    x = _rand(rng, 128, 32)
    _, tidx = _pair(x, "int8")
    q = x[:4] + 0.05 * rng.standard_normal((4, 32)).astype(np.float32)
    for route in (True, False):
        s, i = tidx.with_search(use_pallas=route).search(q)
        d2 = _l2sq(q, x)
        assert (i[:, 0] == np.argmin(d2, axis=1)).all()
        np.testing.assert_allclose(-s[:, 0], d2.min(axis=1), atol=40.0)
        assert (np.diff(s, axis=1) <= 1e-3).all()


@pytest.mark.parametrize("dtype", DTYPES)
def test_search_range_radius_matches_jax(dtype):
    x, q = _data(16, seed=1)
    jidx, tidx = _pair(x, dtype)
    r = 13.0
    d2 = _l2sq(q, x)
    # no row within 1e-3 of the radius: the two packages' f32 sums (and
    # the int8 rows' rounding) cannot fall on different sides of it
    assert np.abs(np.sqrt(d2) - r).min() > 1e-3 or dtype != "float32"
    js, ji, jc = jidx.search_range(q, r, max_results=128)
    for route in (False, True):
        ts, ti, tc = tidx.with_search(use_pallas=route).search_range(
            q, r, max_results=128)
        np.testing.assert_array_equal(tc, np.asarray(jc))
        if route and dtype == "int8":
            # K2 quantizes the query: its members are the rows its int8
            # scores put inside the radius, within the rows' step of it
            inside = d2 <= (r + 1.0) ** 2
            assert all(inside[row, ti[row][ti[row] >= 0]].all()
                       for row in range(len(q)))
            continue
        np.testing.assert_array_equal(ti, np.asarray(ji))
        _assert_close(ts, js)
    if dtype == "float32":
        np.testing.assert_array_equal(tc, (d2 <= r * r).sum(1))
        for row in range(len(q)):
            got = ti[row][ti[row] >= 0]
            assert set(got) == set(np.flatnonzero(d2[row] <= r * r))
            valid = ts[row][ts[row] > -np.inf]
            assert (valid >= -(r * r) - 1e-3).all()
            assert (np.diff(valid) <= 1e-6).all()


def test_knn_graph_and_duplicates_match_jax(rng):
    x = _rand(rng, 90, 16)
    x[11] = x[10] + 0.01          # a near-duplicate at distance ~0.04
    jidx, tidx = _pair(x)
    js, ji = jidx.knn_graph(k=3)
    ts, ti = tidx.knn_graph(k=3)
    np.testing.assert_array_equal(ti, ji)
    _assert_close(ts, js)
    d2 = _l2sq(x, x)
    np.fill_diagonal(d2, np.inf)
    np.testing.assert_array_equal(
        ti, np.argsort(d2, axis=1, kind="stable")[:, :3])
    ms, mi = tidx.knn_graph(k=3, mesh=make_mesh(8, devices=["cpu"] * 8))
    np.testing.assert_array_equal(mi, ti)
    _assert_close(ms, ts)
    jp, jsc = jidx.find_duplicates(tau=0.1)
    tp, tsc = tidx.find_duplicates(tau=0.1)
    np.testing.assert_array_equal(tp, jp)
    assert tp.tolist() == [[10, 11]]
    _assert_close(tsc, jsc)
    assert (tidx.find_duplicates(tau=0.1, group=True)
            == jidx.find_duplicates(tau=0.1, group=True) == [["im10",
                                                              "im11"]])


def test_reconstruct_and_stats_strip_the_norm_column(rng):
    x = _rand(rng, 40, 12)
    jidx, tidx = _pair(x)
    got = tidx.reconstruct(names=["im3", "im0"])
    assert got.shape == (2, 12)
    np.testing.assert_array_equal(got, jidx.reconstruct(names=["im3",
                                                               "im0"]))
    np.testing.assert_array_equal(got, x[[3, 0]])
    assert tidx.reconstruct(names=[]).shape == (0, 12)
    st = tidx.stats()
    assert st["dim"] == jidx.stats()["dim"] == 12
    assert st["metric"] == "l2" and tidx.user_dim == 12 and tidx.dim == 13


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_add_augments_and_repad_does_not_double_augment(rng, dtype):
    x = _rand(rng, 20, 8)
    jidx, tidx = _pair(x, dtype, capacity=24)     # room for one small add
    y = _rand(rng, 3, 8)
    z = _rand(rng, 10, 8)
    for idx in (jidx, tidx):
        assert idx.add(descriptors=y, names=[f"new{j}" for j in
                                             range(3)]) == 3
        # past the capacity: the re-pad path, rows already augmented
        assert idx.add(descriptors=z, names=[f"ovf{j}" for j in
                                             range(10)]) == 10
    assert tidx.dim == jidx.dim == 9 and tidx.descriptors.shape[0] == 48
    np.testing.assert_allclose(tidx._rows_f32_chunk(0, 48).numpy(),
                               np.asarray(jidx._rows_f32_chunk(0, 48)),
                               rtol=1e-6, atol=1e-6)
    q = _rand(rng, 4, 8)
    js, ji = jidx.search(q)
    ts, ti = tidx.with_search(use_pallas=False).search(q)
    np.testing.assert_array_equal(ti, np.asarray(ji))
    _assert_close(ts, js)
    if dtype == "float32":
        d2 = _l2sq(q, np.concatenate([x, y, z]))
        np.testing.assert_array_equal(
            ti, np.argsort(d2, axis=1, kind="stable")[:, :5])


@pytest.mark.parametrize("dtype", DTYPES)
def test_save_load_both_ways(dtype, tmp_path):
    x, q = _data(24, seed=2)
    jidx, tidx = _pair(x, dtype)
    tidx.save(str(tmp_path / "port"))
    jidx.save(str(tmp_path / "jax"), streaming=False)
    from_port = JaxIndex.load(str(tmp_path / "port"))
    from_jax = Index.load(str(tmp_path / "jax"), device="cpu")
    assert from_port.is_l2 and from_jax.is_l2 and from_jax.dim == 25
    js, ji = from_port.search(q)
    ts, ti = from_jax.with_search(use_pallas=False).search(q)
    np.testing.assert_array_equal(ti, np.asarray(ji))
    _assert_close(ts, js)
    # each reload answers as the index that was saved
    for saved, back in ((tidx, Index.load(str(tmp_path / "port"),
                                          device="cpu")),
                        (jidx, JaxIndex.load(str(tmp_path / "jax")))):
        a, b = saved.search(q), back.search(q)
        np.testing.assert_array_equal(np.asarray(a[1]), np.asarray(b[1]))
        np.testing.assert_array_equal(np.asarray(a[0]), np.asarray(b[0]))


def test_sharded_ranking_equals_single(rng):
    x = _rand(rng, 160, 16)
    _, tidx = _pair(x)
    q = _rand(rng, 4, 16)
    want_s, want_i = tidx.search(q)
    sidx = tidx.to_sharded(mesh=make_mesh(8, devices=["cpu"] * 8))
    assert sidx.l2
    got_s, got_i = sidx.search(q, k=5)       # queries of the caller's width
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    qn2 = (q * q).sum(1)
    _assert_close(2.0 * got_s.numpy() - qn2[:, None], want_s)


def test_gates_reject_cosine_stages(rng):
    x = _rand(rng, 64, 16)
    _, tidx = _pair(x)
    for call in (tidx.build_ivf, tidx.build_pq, tidx.build_ivfpq,
                 tidx.fit_local_whitening, tidx.augment_database):
        with pytest.raises(ValueError, match="l2"):
            call()
    for stage in ("qe_enabled", "rerank_enabled", "diffusion_enabled"):
        with pytest.raises(ValueError, match="l2"):
            tidx.search(x[:2], tidx.cfg.search.replace(**{stage: True}))
    with pytest.raises(ValueError, match="l2"):
        Index.build(["x.jpg"], PipelineConfig(
            extract=ExtractConfig(dtype="float32"),
            index=IndexConfig(metric="l2")), device="cpu")
    with pytest.raises(ValueError, match="int4"):
        _pair(x, "int4")
    with pytest.raises(ValueError, match="metric"):
        Index.from_descriptors(x, [f"im{i}" for i in range(64)],
                               PipelineConfig(index=IndexConfig(
                                   metric="cosine")), device="cpu")


def test_merge_metric_mismatch_and_l2_union(rng):
    x, y = _rand(rng, 24, 8), _rand(rng, 16, 8)
    other = [f"other{i}" for i in range(16)]
    ja, ta = _pair(x)
    jb, tb = _pair(y, names=other)
    ip = Index.from_descriptors(y, [f"c{i}" for i in range(16)],
                                PipelineConfig(
                                    extract=ExtractConfig(dtype="float32"),
                                    index=IndexConfig(row_tile=8)),
                                device="cpu")
    with pytest.raises(ValueError, match="metric"):
        ta.merge_from(ip)
    assert ta.merge_from(tb) == ja.merge_from(jb) == 16
    q = _rand(rng, 3, 8)
    js, ji = ja.search(q)
    ts, ti = ta.with_search(use_pallas=False).search(q)
    np.testing.assert_array_equal(ti, np.asarray(ji))
    _assert_close(ts, js)
    d2 = _l2sq(q, np.concatenate([x, y]))
    np.testing.assert_array_equal(
        ti, np.argsort(d2, axis=1, kind="stable")[:, :5])
