"""A search through an armed candidate tier on a placed store
(``Index.load(path, mesh=)``): the PQ, IVF and IVF-PQ cascades read their
exact re-score's, αQE's and the regional re-rank's rows from the shards
and leave the store placed, as the reference's ``Index.search`` leaves its
store ``P('shard')`` (its composites index the sharded arrays; nothing
reassigns them).

120 rows in a capacity of 128 at row tile 8 on ``make_mesh(8, devices=
["cpu"] * 8)`` (16 rows a shard, the last all padding), D = 40,
bf16/f32/int8/int4, an int8 regional store (R = 3) on the int8 index. The
JAX package builds each index and fits its views once (module fixture):
PQ (with IVF beside it where the store is not int4) and, apart, IVF-PQ,
saved in the npz form both packages read. Each case loads the save three
ways: placed by the port (with ``Index.gather`` patched to raise), unplaced
by the port (the twin), and placed by the JAX package onto its eight
virtual devices. What is checked, for every tier and store kind, plain,
with αQE, with the regional re-rank (int8) and with a subset:
  * the placed answers equal the twin's (ids equal, scores within 1e-6),
    on both routes (K4's plain version and the scoring oracle for PQ);
  * the placed oracle-route answers equal the JAX placed index's (ids
    equal, scores within 1e-5; the JAX Index takes its oracle on the CPU);
  * the JAX store still reads ``P('shard')`` after its search, and the
    port's ``placed`` is still True.
Also the views' public ``candidates``/``search``/``measure_recall`` on the
placed store, and ``ServeCore`` with a tier armed before and after
``ServeCore.mutate``. The two-process form (the collective row reads and
the views' absorbs across processes) is in
tests/test_torch_placed_mutation.py.
"""
import os

import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from instsearch_tpu import IndexConfig as JaxIndexConfig
from instsearch_tpu import PipelineConfig as JaxPipelineConfig
from instsearch_tpu import SearchConfig as JaxSearchConfig
from instsearch_tpu.index import Index as JaxIndex
from instsearch_tpu.index import attach_regional_store as jax_attach_regional
from instsearch_tpu.parallel.mesh import make_mesh as jax_make_mesh
from instsearch_torch.index import Index
from instsearch_torch.parallel import make_mesh
from instsearch_torch.serve import ServeCore

N, CAPACITY, D, R, SHARDS = 120, 128, 40, 3, 8
DTYPES = ("bfloat16", "float32", "int8", "int4")
K, DEPTH, NPROBE = 7, 24, 3
# the tiers' search configs over the index's own: each arms one tier (IVF
# comes first in the reference's order, so the PQ case disarms it)
TIERS = {"pq": dict(pq_depth=DEPTH, ivf_nprobe=0),
         "ivf": dict(ivf_nprobe=NPROBE, pq_depth=0),
         "ivfpq": dict(ivfpq_nprobe=NPROBE)}
MODES = {"plain": dict(),
         "qe": dict(qe_enabled=True, qe_n=4),
         "rerank": dict(rerank_enabled=True, rerank_depth=12),
         "subset": dict()}
CASES = [(tier, dtype, mode) for tier in TIERS for dtype in DTYPES
         for mode in MODES
         if not (tier == "ivf" and dtype == "int4")
         and (mode != "rerank" or dtype == "int8")]


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """Small CPU tensors in a worker process: one intra-op thread,
    restored afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _mesh():
    return make_mesh(SHARDS, devices=["cpu"] * SHARDS)


def _unit(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _rows():
    rng = np.random.default_rng(2401)
    x = _unit(rng, (N, D))
    q = x[[2, 40, 90]] + 0.2 * rng.standard_normal((3, D)).astype(
        np.float32)
    return x, q, _unit(rng, (N, R, D)), _unit(rng, (3, R, D))


def _group(tier):
    return "ivfpq" if tier == "ivfpq" else "pq"


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """For each store kind, the JAX index with its PQ view (and IVF view
    but on int4) and, apart, with its IVF-PQ view, saved as npz; and each
    loaded placed by the JAX package once (its searches change nothing)."""
    tmp = tmp_path_factory.mktemp("placed_tiers")
    x, _, reg, _ = _rows()
    names = [f"im{i}" for i in range(N)]
    paths, refs = {}, {}
    for dtype in DTYPES:
        for group in ("pq", "ivfpq"):
            cfg = JaxPipelineConfig(
                index=JaxIndexConfig(dtype=dtype, row_tile=8,
                                     capacity=CAPACITY),
                search=JaxSearchConfig(k=K, query_chunk=2))
            jidx = JaxIndex.from_descriptors(x, names, cfg)
            if dtype == "int8":
                jax_attach_regional(jidx, reg)
            if group == "pq":
                jidx.build_pq(m=4, iters=3, sample=None, depth=DEPTH)
                if dtype != "int4":
                    jidx.build_ivf(n_clusters=8, nprobe=NPROBE, iters=3,
                                   sample=None)
            else:
                jidx.build_ivfpq(n_clusters=8, nprobe=NPROBE, m=4,
                                 kmeans_iters=3, pq_iters=3, sample=None,
                                 depth=DEPTH)
            path = str(tmp / f"{dtype}_{group}")
            jidx.save(path, streaming=False)
            paths[dtype, group] = path
            refs[dtype, group] = JaxIndex.load(path,
                                               mesh=jax_make_mesh(SHARDS))
    return paths, refs


@pytest.fixture()
def no_gather(monkeypatch):
    """``Index.gather`` raising for the test (the class: twins made by
    ``with_search`` share the placement)."""
    def refuse(self):
        raise AssertionError("the placed store was gathered")
    monkeypatch.setattr(Index, "gather", refuse)


def _same(got, want, atol=1e-6):
    """Integer arrays (ids) equal; scores within ``atol``."""
    for a, b in zip(got, want):
        a, b = np.asarray(a), np.asarray(b)
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=0, atol=atol)
        else:
            np.testing.assert_array_equal(a, b)


def _load(path):
    placed = Index.load(path, mesh=_mesh())
    twin = Index.load(path, device="cpu")
    assert placed.placed and not twin.placed
    return placed, twin


def _request(tier, mode, cfg):
    """(search config, keyword arguments) of a case."""
    _, q, _, qreg = _rows()
    scfg = cfg.search.replace(**TIERS[tier], **MODES[mode])
    kw = {}
    if mode == "rerank":
        kw["query_regional"] = qreg
    if mode == "subset":
        kw["subset"] = [f"im{i}" for i in range(0, N, 3)]
    return q, scfg, kw


@pytest.mark.parametrize("tier,dtype,mode", CASES)
def test_tier_on_a_placed_store(saved, no_gather, tier, dtype, mode):
    paths, refs = saved
    placed, twin = _load(paths[dtype, _group(tier)])
    q, scfg, kw = _request(tier, mode, twin.cfg)
    got = placed.search(q, scfg, **kw)
    _same(got, twin.search(q, scfg, **kw))
    assert np.isfinite(got[0][:, 0]).all() and (got[1][:, 0] >= 0).all()
    if mode == "subset":
        assert set(got[1][got[1] >= 0].tolist()) <= set(range(0, N, 3))
    oracle = placed.with_search(use_pallas=False)
    want = twin.with_search(use_pallas=False)
    po = oracle.search(q, scfg, **kw)
    _same(po, want.search(q, scfg, **kw))
    ref = refs[dtype, _group(tier)]
    jscfg = ref.cfg.search.replace(**TIERS[tier], **MODES[mode])
    js, ji = ref.search(q, jscfg, **kw)
    np.testing.assert_array_equal(po[1], np.asarray(ji))
    np.testing.assert_allclose(po[0], np.asarray(js), rtol=0, atol=1e-5)
    assert ref.descriptors.sharding.spec == P("shard")
    assert placed.placed and oracle.placed


@pytest.mark.parametrize("dtype", DTYPES)
def test_views_public_searches_on_a_placed_store(saved, no_gather, dtype):
    """``PQView``/``IVFPQView`` ``candidates``, ``search`` and
    ``measure_recall`` and ``IVFIndex.search``/``measure_recall`` on the
    placed store equal the twin's and keep it placed."""
    paths, _ = saved
    _, q, _, _ = _rows()
    for group in ("pq", "ivfpq"):
        placed, twin = _load(paths[dtype, group])
        views = ([("pq", placed.pq, twin.pq)] if group == "pq" else
                 [("ivfpq", placed.ivfpq, twin.ivfpq)])
        if group == "pq" and dtype != "int4":
            views.append(("ivf", placed.ivf, twin.ivf))
        for name, pv, tv in views:
            if name == "ivf":
                _same(pv.search(placed, q, k=K), tv.search(twin, q, k=K))
                _same(pv.candidates(q, K), tv.candidates(q, K))
            else:
                _same(pv.candidates(placed, q), tv.candidates(twin, q))
                _same(pv.search(placed, q, k=K), tv.search(twin, q, k=K))
            assert (pv.measure_recall(placed, q, k=K)
                    == tv.measure_recall(twin, q, k=K))
        assert placed.placed


class _TableExtractor:
    """An extractor stand-in for ``ServeCore``: an image's descriptor is
    the row of a table its first pixel names, a file's by its name (the
    tier's search is what is under test)."""

    def __init__(self, queries, files):
        self.queries, self.files = queries, files
        self.whitening = None
        self.device = torch.device("cpu")

    def __call__(self, images):
        return torch.as_tensor(self.queries[np.asarray(images)[:, 0, 0, 0]])

    def extract_paths(self, paths, quarantine):
        keys = [os.path.splitext(os.path.basename(p))[0] for p in paths]
        return np.stack([self.files[k] for k in keys]), list(range(len(keys)))


@pytest.mark.parametrize("dtype,group", [("int4", "pq"), ("float32", "pq"),
                                         ("bfloat16", "ivfpq")])
def test_serve_core_serves_a_placed_tier(saved, no_gather, dtype, group):
    """``ServeCore`` over a placed index with its tier armed answers as the
    twin's before and after ``mutate`` (an add, a remove, an add), and the
    store stays placed throughout."""
    paths, _ = saved
    x, q, _, _ = _rows()
    rng = np.random.default_rng(2402)
    files = {f"s{i}": r for i, r in enumerate(_unit(rng, (4, D)))}
    pool = np.concatenate([q, _unit(rng, (2, D)), x[[5, 60]]])
    cores = []
    for idx in _load(paths[dtype, group]):
        idx.extractor = _TableExtractor(pool, files)
        if group == "pq" and dtype != "int4":   # the PQ cascade, not IVF
            idx.cfg = idx.cfg.replace(
                search=idx.cfg.search.replace(ivf_nprobe=0))
        cores.append(ServeCore(idx))
    images = np.zeros((len(pool), 4, 4, 3), np.uint8)
    images[:, 0, 0, 0] = np.arange(len(pool))
    jobs = [(images[:3], 5), (images[3:], K)]
    reqs = [None, {"add": [f"/img/s{i}.png" for i in range(4)]},
            {"remove": ["im5", "s1", "im119"]},
            {"add": [f"/img/s{i}.png" for i in range(1, 2)]}]
    for req in reqs:
        if req is not None:
            got = [c.mutate(req) for c in cores]
            assert got[0]["rows"] == got[1]["rows"]
        a, b = (c.run_queries(jobs) for c in cores)
        for ra, rb in zip(a, b):
            assert [[r["id"] for r in row] for row in ra["results"]] == \
                [[r["id"] for r in row] for row in rb["results"]]
            np.testing.assert_allclose(
                [[r["score"] for r in row] for row in ra["results"]],
                [[r["score"] for r in row] for row in rb["results"]],
                rtol=0, atol=1e-6)
        assert cores[0].idx.placed
    assert cores[0].idx.num_valid == N + 2
