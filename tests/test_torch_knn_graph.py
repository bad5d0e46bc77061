"""The kNN graph, near-duplicate search and stats of the port's Index
(``Index.knn_graph``, ``find_duplicates``, ``stats``) against
``instsearch_tpu``'s on the same seeded rows.

The store: 150 seeded unit rows in a capacity of 192 (row tile 64, D = 32)
with three byte-identical copies (rows 20, 21 of 7; row 90 of 40: the self
is struck by POSITION, so a copy stays its twin's neighbour at score 1),
and four near-duplicates (cosine ~0.99) chained so that a~b and b~c but
a.c < tau, which ``group=True`` joins through the union-find.

Tolerances: ids equal (the seeded rows have no near-tie at the k-th
neighbour but among the copies, whose order is by position in both);
scores within 1e-6 (f32 sums in two orders; equal bytes in int8/int4 on
the oracle route). The kernel route (K1-K3's plain versions) is held to the
reference's ``_knn_chunk_jit(use_pallas=True)`` with the Pallas kernels in
interpret mode.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest

import instsearch_tpu.kernels as jax_kernels
from instsearch_tpu.config import IndexConfig as JaxIndexConfig
from instsearch_tpu.config import PipelineConfig as JaxPipelineConfig
from instsearch_tpu.config import SearchConfig as JaxSearchConfig
from instsearch_tpu.index import Index as JaxIndex
from instsearch_tpu.index import _knn_chunk_jit
from instsearch_tpu.index import attach_regional_store as jax_attach_regional
from instsearch_torch import PipelineConfig
from instsearch_torch.index import Index, attach_regional_store

N, CAP, D = 150, 192, 32
COPIES = ((7, 20), (7, 21), (40, 90))
TOL = 1e-6
JAX_KERNELS = {"bfloat16": "topk_matmul", "int8": "topk_matmul_int8",
               "int4": "topk_matmul_int4"}


def _rows():
    rng = np.random.default_rng(11)
    x = rng.standard_normal((N, D)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    for src, dst in COPIES:
        x[dst] = x[src]
    # a chain of near-duplicates: 100 ~ 101 ~ 102, 100 . 102 below 0.97
    step = rng.standard_normal(D).astype(np.float32)
    step -= (step @ x[100]) * x[100]
    step /= np.linalg.norm(step)
    for j, t in ((101, 0.17), (102, 0.34)):
        v = x[100] + t * step
        x[j] = v / np.linalg.norm(v)
    v = x[130] + 0.1 * step
    x[131] = v / np.linalg.norm(v)
    return x


def _pair(dtype="float32", use_pallas=False):
    x = _rows()
    cfg = JaxPipelineConfig(
        index=JaxIndexConfig(dtype=dtype, row_tile=64, capacity=CAP),
        search=JaxSearchConfig(use_pallas=use_pallas, query_chunk=64))
    names = [f"img{i:03d}" for i in range(N)]
    jidx = JaxIndex.from_descriptors(x, names, cfg)
    tidx = Index.from_descriptors(x, names,
                                  PipelineConfig.from_json(cfg.to_json()),
                                  device="cpu")
    return jidx, tidx


def _assert_graph(want, got):
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(np.isfinite(got[0]), np.isfinite(want[0]))
    fin = np.isfinite(want[0])
    np.testing.assert_allclose(got[0][fin], want[0][fin], rtol=0, atol=TOL)


@pytest.mark.parametrize("k,chunk", [(5, None), (8, 48), (3, 200)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8", "int4"])
def test_knn_graph_matches_jax(dtype, k, chunk):
    """``chunk=48`` slides the last chunk back; 200 is cut to N_pad."""
    jidx, tidx = _pair(dtype)
    want = jidx.knn_graph(k=k, chunk=chunk)
    got = tidx.knn_graph(k=k, chunk=chunk)
    _assert_graph(want, got)
    s, i = got
    assert i.shape == (N, k) and (i != np.arange(N)[:, None]).all()
    # a byte-identical copy is its twin's first neighbour, at its score
    for src, dst in COPIES:
        assert i[dst, 0] in {src, 20, 21} - {dst}
        assert abs(s[dst, 0] - s[src, 0]) < 1e-6 or dtype != "float32"


def test_knn_graph_subset_restricts_the_neighbours():
    jidx, tidx = _pair()
    members = list(range(0, N, 3))
    want = jidx.knn_graph(k=6, subset=members)
    got = tidx.knn_graph(k=6, subset=members)
    _assert_graph(want, got)
    assert set(got[1][got[1] >= 0].tolist()) <= set(members)
    few = [3, 6]                      # fewer members than k: (-inf, -1)
    s, i = tidx.knn_graph(k=4, subset=few)
    _assert_graph(jidx.knn_graph(k=4, subset=few), (s, i))
    assert (i[:, 2:] == -1).all() and np.isinf(s[:, 2:]).all()


@pytest.mark.parametrize("dtype", ["bfloat16", "int8", "int4"])
def test_knn_graph_kernel_route_matches_jax_kernels(dtype, monkeypatch):
    jidx, tidx = _pair(dtype, use_pallas=True)
    name = JAX_KERNELS[dtype]
    monkeypatch.setattr(jax_kernels, name, functools.partial(
        getattr(jax_kernels, name), interpret=True))
    k, chunk = 6, 64
    want_s = np.full((N, k), -np.inf, np.float32)
    want_i = np.full((N, k), -1, np.int32)
    for start in range(0, N, chunk):
        s0 = min(start, CAP - chunk)
        s, i = _knn_chunk_jit(jidx.descriptors, jidx.ids,
                              jnp.asarray(N, jnp.int32), jidx.scales,
                              jnp.asarray(s0, jnp.int32), k=k,
                              use_pallas=True, chunk=chunk,
                              int4=jidx.is_int4)
        off, take = start - s0, min(chunk, N - start)
        want_s[start:start + take] = np.asarray(s)[off:off + take]
        want_i[start:start + take] = np.asarray(i)[off:off + take]
    _assert_graph((want_s, want_i), tidx.knn_graph(k=k, chunk=chunk))


def test_find_duplicates_matches_jax():
    jidx, tidx = _pair()
    jp, js = jidx.find_duplicates(tau=0.97, k=4)
    tp, ts = tidx.find_duplicates(tau=0.97, k=4)
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_allclose(ts, js, atol=TOL)
    pairs = {tuple(p) for p in tp.tolist()}
    assert {(7, 20), (7, 21), (20, 21), (40, 90), (100, 101), (101, 102),
            (130, 131)} <= pairs
    assert (100, 102) not in pairs          # 0.955: below tau
    groups = tidx.find_duplicates(tau=0.97, k=4, group=True)
    assert groups == jidx.find_duplicates(tau=0.97, k=4, group=True)
    assert ["img100", "img101", "img102"] in groups
    assert ["img007", "img020", "img021"] in groups
    empty = tidx.find_duplicates(tau=1.5)
    assert empty[0].shape == (0, 2) and empty[1].shape == (0,)


def test_stats_match_jax():
    """Every key the reference reports for the views the port has; at D =
    32 the store's width is the kernels' multiple, so the bytes agree
    too. The PQ view's codes are padded to whole words in the port."""
    x = _rows()
    for dtype in ("bfloat16", "int8", "int4"):
        jidx, tidx = _pair(dtype)
        reg = np.repeat(x[:, None, :], 2, axis=1)
        jax_attach_regional(jidx, reg)
        attach_regional_store(tidx, reg)
        jidx.fit_local_whitening(n_clusters=4)
        tidx.fit_local_whitening(n_clusters=4)
        want, got = jidx.stats(), tidx.stats()
        assert got == want, (got, want)
    jidx, tidx = _pair("int4")
    jidx.build_pq(m=4, iters=2, depth=20)
    tidx.build_pq(m=4, iters=2, depth=20)
    want, got = jidx.stats(), tidx.stats()
    assert got["pq"] == want["pq"]
    assert {k: v for k, v in got["bytes"].items() if k not in ("pq",
                                                                "total")} \
        == {k: v for k, v in want["bytes"].items() if k not in ("pq",
                                                                 "total")}
    assert got["bytes"]["pq"] == tidx.pq.packed.numel()
