"""The PQ cascade serving path of the port (ops/pq.py, search/pq_view.py,
``Index.build_pq`` and its routing) against the JAX Index over the same
store and the same codes: the port's view is built with
``PQView.from_arrays`` from the JAX view's centroids and codes.

What is compared, and the tolerances:
  * the oracle route (the port index's own config has use_pallas off)
    against the reference's ``_pq_composite_jit(use_pallas=False)``: the
    f32 lookup table against the one-hot codes, the exact re-score, with
    and without alpha-QE. Both sum f32 in their own order, so scores agree
    to 2e-5 and ids are equal except where JAX scores the two ids within
    NEAR_TIE = 2e-5 of each other.
  * the kernel route (K4's plain version on a CPU store) against
    ``_pq_composite_jit(use_pallas=True)`` with the Pallas kernel in
    interpret mode: the same bf16 table, summed in two orders (2e-5, see
    test_torch_pq_scan.py), then the same exact re-score; the same rule.
  * at full depth the cascade is exact search, as the reference pins
    (tests/integration/test_pq_index.py): ids equal to the port's own
    exact oracle route, scores to 1e-5.
"""
import functools
import json

import jax.numpy as jnp
import numpy as np
import pytest

import instsearch_tpu.kernels.pq_scan as jax_scan
import instsearch_torch.index as tindex
import instsearch_torch.search.pq_view as tview
from instsearch_tpu.config import (ExtractConfig, IndexConfig, PipelineConfig,
                                   SearchConfig)
from instsearch_tpu.index import Index as JaxIndex
from instsearch_tpu.search.pq_view import _pq_composite_jit
from instsearch_torch import PipelineConfig as TorchPipelineConfig
from instsearch_torch.extractor import Extractor
from instsearch_torch.index import Index
from instsearch_torch.search.pq_view import PQView
from instsearch_torch.serve import ServeCore

NEAR_TIE = 2e-5
DEPTH = 64


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _clustered(rng, n_per, centers, d, noise=0.05):
    x = np.repeat(_unit(rng, centers, d), n_per, axis=0)
    x = x + noise * rng.standard_normal(x.shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _cfg(dtype: str) -> PipelineConfig:
    return PipelineConfig(
        extract=ExtractConfig(dtype="float32"),
        index=IndexConfig(dtype=dtype, row_tile=8),
        search=SearchConfig(k=10, qe_n=5, qe_alpha=3.0))


def _attach(idx, view):
    """Attach ``view`` and arm the routing, as build_pq does."""
    idx.pq = view
    idx.cfg = idx.cfg.replace(search=idx.cfg.search.replace(
        pq_depth=view.depth))
    return idx


@pytest.fixture(scope="module", params=["float32", "int8", "int4"])
def rig(request):
    """A JAX Index with a PQ view, and the port's Index over the same rows
    (its store byte-equal, test_torch_qe_slice.py) with a view over the JAX
    view's centroids and codes."""
    rng = np.random.default_rng(0)
    x = _clustered(rng, n_per=48, centers=8, d=32)
    names = [f"im{i}" for i in range(len(x))]
    cfg = _cfg(request.param)
    jidx = JaxIndex.from_descriptors(x, names, cfg)
    jidx.build_pq(m=4, iters=6, depth=DEPTH)
    tidx = Index.from_descriptors(
        x, names, TorchPipelineConfig.from_json(cfg.to_json()), device="cpu")
    jv = jidx.pq
    _attach(tidx, PQView.from_arrays(np.asarray(jv.codebook.centroids),
                                     np.asarray(jv.codes), depth=DEPTH,
                                     device="cpu"))
    q = np.concatenate([x[::37], _unit(rng, 4, 32)])
    return request.param, x, q, jidx, tidx


def _assert_topk_agree(js, ji, ts, ti, score_tol=NEAR_TIE):
    for q in range(ji.shape[0]):
        jscore = dict(zip(ji[q].tolist(), js[q].tolist()))
        for a, b in zip(ji[q], ti[q]):
            if a != b:
                assert b in jscore, (q, a, b)
                assert abs(jscore[a] - jscore[b]) < NEAR_TIE, (q, a, b)
    np.testing.assert_allclose(ts, js, rtol=0, atol=score_tol)


def _jax_composite(jidx, q, do_qe, use_pallas):
    jv, scfg = jidx.pq, jidx.cfg.search
    s, i = _pq_composite_jit(
        jv.codes, jv.codebook.centroids, jidx.descriptors, jidx.ids,
        jidx.scales, None, None, None, jnp.asarray(q),
        jnp.asarray(jidx.num_valid, jnp.int32), k=scfg.k, depth=DEPTH,
        qe_n=scfg.qe_n, qe_alpha=scfg.qe_alpha, do_qe=do_qe,
        do_rerank=False, int4=jidx.is_int4, use_pallas=use_pallas)
    return np.asarray(s), np.asarray(i)


@pytest.mark.parametrize("do_qe", [False, True])
def test_oracle_route_matches_jax_composite(rig, do_qe):
    _, _, q, jidx, tidx = rig
    js, ji = _jax_composite(jidx, q, do_qe, use_pallas=False)
    ts, ti = tidx.with_search(use_pallas=False).search(
        q, tidx.cfg.search.replace(qe_enabled=do_qe))
    _assert_topk_agree(js, ji, ts, ti)


@pytest.mark.parametrize("do_qe", [False, True])
def test_kernel_route_matches_jax_composite(rig, do_qe, monkeypatch):
    _, _, q, jidx, tidx = rig
    monkeypatch.setattr(jax_scan, "pq_topk", functools.partial(
        jax_scan.pq_topk, interpret=True))
    js, ji = _jax_composite(jidx, q, do_qe, use_pallas=True)
    ts, ti = tidx.search(q, tidx.cfg.search.replace(qe_enabled=do_qe))
    _assert_topk_agree(js, ji, ts, ti)


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("do_qe", [False, True])
def test_full_depth_equals_exact_search(rig, use_pallas, do_qe):
    _, x, q, _, tidx = rig
    twin = tidx.with_search(use_pallas=use_pallas)
    scfg = tidx.cfg.search.replace(qe_enabled=do_qe)
    es, ei = tidx.with_search(use_pallas=False).search(
        q, scfg.replace(pq_depth=0))
    ps, pi = twin.search(q, scfg.replace(pq_depth=len(x)))
    np.testing.assert_array_equal(pi, ei)
    np.testing.assert_allclose(ps, es, rtol=0, atol=1e-5)
    # recall against the exact route of the same semantics (on the kernel
    # route an int8/int4 store quantizes the query, the re-score does not)
    oracle = tidx.with_search(use_pallas=False)
    assert oracle.pq.measure_recall(oracle, q, k=10, depth=len(x)) == 1.0


def test_routes_reach_their_entries(rig, monkeypatch):
    """K4's entry runs once per cascade stage on the kernel route (twice
    with QE: top-qe_n, then the final selection), never on the oracle
    route, and no top-k kernel of the exact path runs under the cascade."""
    _, _, q, _, tidx = rig
    calls = []

    def spy(mod, name):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, functools.partial(
            lambda f, nm, *a, **kw: calls.append(nm) or f(*a, **kw), fn,
            name))

    spy(tview, "pq_topk")
    for name in ("topk_matmul", "topk_matmul_int8", "topk_matmul_int4",
                 "search_topk"):
        spy(tindex, name)
    qe = tidx.cfg.search.replace(qe_enabled=True)
    tidx.search(q, qe)
    assert calls == ["pq_topk"] * 2
    calls.clear()
    tidx.with_search(use_pallas=False).search(q, qe)
    assert calls == []
    calls.clear()
    tidx.search(q, qe.replace(pq_depth=0))            # the exact path
    assert "pq_topk" not in calls and len(calls) == 2


def test_pq_view_search_matches_index_search(rig):
    _, _, q, _, tidx = rig
    vs, vi = tidx.pq.search(tidx, q, k=10)
    s, i = tidx.search(q, tidx.cfg.search.replace(qe_enabled=False))
    np.testing.assert_array_equal(vi, i)
    np.testing.assert_array_equal(vs, s)


def test_build_pq_arms_routing_and_matches_jax_codes(rig):
    kind, x, q, jidx, _ = rig
    names = [f"im{i}" for i in range(len(x))]
    own = Index.from_descriptors(
        x, names, TorchPipelineConfig.from_json(_cfg(kind).to_json()),
        device="cpu")
    assert own.cfg.search.pq_depth == 0
    view = own.build_pq(m=4, iters=6, depth=DEPTH)
    assert own.pq is view and own.cfg.search.pq_depth == DEPTH
    assert own.with_search(use_pallas=False).pq is view
    np.testing.assert_allclose(view.codebook.centroids.numpy(),
                               np.asarray(jidx.pq.codebook.centroids),
                               rtol=0, atol=1e-4)
    same = (view.codes.numpy() == np.asarray(jidx.pq.codes)).all(axis=1)
    assert same.mean() > 0.99
    s, i = own.search(q)
    assert i.shape == (len(q), 10) and np.isfinite(s).all()


def test_depth_without_a_view_takes_the_exact_path(rig):
    _, _, q, jidx, tidx = rig
    plain = Index(tidx.descriptors, tidx.ids, tidx.names, tidx.cfg,
                  scales=tidx.scales)
    assert plain.pq is None and plain.cfg.search.pq_depth == DEPTH
    s, i = plain.search(q)
    es, ei = tidx.search(q, tidx.cfg.search.replace(pq_depth=0))
    np.testing.assert_array_equal(i, ei)
    # the IVF and IVF-PQ tiers' settings without their views are ignored,
    # as in the reference: the PQ cascade answers, as JAX's does
    oracle = tidx.with_search(use_pallas=False)
    for field in ("ivf_nprobe", "ivfpq_nprobe"):
        ts, ti = oracle.search(q, oracle.cfg.search.replace(**{field: 4}))
        ws, wi = oracle.search(q)
        np.testing.assert_array_equal(ti, wi)
        np.testing.assert_array_equal(ts, ws)
        js, ji = jidx.search(q, jidx.cfg.search.replace(**{field: 4}))
        _assert_topk_agree(np.asarray(js), np.asarray(ji), ts, ti)


def test_candidate_recall_on_clustered_corpus_matches_jax(rng):
    """The reference's recall pin (tests/integration/test_pq_index.py): on a
    clustered corpus a depth-100 cascade finds > 85% of the exact top-10.
    Over the JAX view's codes the port's oracle route measures the same
    recall."""
    x = _clustered(rng, n_per=64, centers=16, d=64)
    names = [f"im{i}" for i in range(len(x))]
    cfg = _cfg("float32")
    jidx = JaxIndex.from_descriptors(x, names, cfg)
    jpq = jidx.build_pq(m=8, iters=10, depth=100)
    tidx = Index.from_descriptors(
        x, names, TorchPipelineConfig.from_json(cfg.to_json()),
        device="cpu").with_search(use_pallas=False)
    tpq = PQView.from_arrays(np.asarray(jpq.codebook.centroids),
                             np.asarray(jpq.codes), depth=100, device="cpu")
    q = x[rng.choice(len(x), 16, replace=False)]
    q = q + 0.02 * rng.standard_normal(q.shape).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    want = jpq.measure_recall(jidx, q, k=10, depth=100)
    got = tpq.measure_recall(tidx, q, k=10, depth=100)
    assert got > 0.85 and got == pytest.approx(want, abs=0.02)


def test_positions_map_to_dataset_ids(rng):
    x = _unit(rng, 64, 16)
    original = np.arange(5, 69, dtype=np.int32)
    idx = Index.from_descriptors(
        x, [f"im{i}" for i in range(64)],
        TorchPipelineConfig.from_json(_cfg("float32").to_json()),
        original_ids=original, device="cpu")
    pq = idx.build_pq(m=2, iters=4, depth=64)
    _, ids = pq.search(idx, x[:3], k=1)
    np.testing.assert_array_equal(ids[:, 0], original[:3])


def test_unported_parts_raise(rig, tmp_path):
    """The anisotropic fit (ported since ROADMAP M9) builds on a twin: its
    codes equal the JAX fit's on >= 99% of the rows and its threshold rides
    a saved view both ways; the view saves and loads (codes unpadded on
    disk, padded to words again), and absorbing rows already stored
    re-encodes them to the same codes."""
    _, _, _, jidx, tidx = rig
    twin = tidx.with_search()
    aniso = twin.build_pq(m=4, iters=2, anisotropic_t=0.2)
    jtwin = JaxIndex(jidx.descriptors, jidx.ids, jidx.names, jidx.cfg,
                     scales=jidx.scales)
    janiso = jtwin.build_pq(m=4, iters=2, anisotropic_t=0.2)
    assert aniso.anisotropic_t == janiso.anisotropic_t == 0.2
    same = (aniso.codes.numpy() == np.asarray(janiso.codes)).all(axis=1)
    assert same.mean() >= 0.99
    assert tidx.pq is not aniso
    before = tidx.pq.packed.clone()
    tidx.pq.save(str(tmp_path))
    back = PQView.load(str(tmp_path), device="cpu")
    assert back.depth == tidx.pq.depth
    np.testing.assert_array_equal(back.packed.numpy(), before.numpy())
    tidx.pq.absorb_add(tidx, 0, 1)
    np.testing.assert_array_equal(tidx.pq.packed.numpy(), before.numpy())
    with open(tmp_path / "pq.json", "w") as f:
        json.dump({"depth": 10, "anisotropic_t": 0.2}, f)
    assert PQView.load(str(tmp_path), device="cpu").anisotropic_t == 0.2
    janiso.save(str(tmp_path / "jax"))
    loaded = PQView.load(str(tmp_path / "jax"), device="cpu")
    assert loaded.anisotropic_t == 0.2
    np.testing.assert_array_equal(loaded.codes.numpy(),
                                  np.asarray(janiso.codes))


def test_serve_core_answers_through_the_cascade(rng, monkeypatch):
    """Images -> ResNet-18 -> GeM -> f32 store with a full-depth PQ view
    and alpha-QE -> ServeCore: the requests go through K4's entry, and the
    answers are query_images' and, the depth covering the store, the exact
    path's."""
    cfg = TorchPipelineConfig.from_json(PipelineConfig(
        extract=ExtractConfig(backbone="resnet18", pooling="gem",
                              image_size=32, dtype="float32", batch_size=8),
        index=IndexConfig(dtype="float32", row_tile=8),
        search=SearchConfig(k=5, qe_enabled=True, qe_n=3)).to_json())
    ex = Extractor(cfg.extract, seed=0, device="cpu")
    images = rng.integers(0, 256, size=(40, 32, 32, 3), dtype=np.uint8)
    idx = Index.from_descriptors(ex(images), [f"im{i}" for i in range(40)],
                                 cfg, extractor=ex)
    idx.build_pq(iters=4, depth=40)
    core = ServeCore(idx)
    calls = []
    monkeypatch.setattr(tview, "pq_topk", functools.partial(
        lambda f, *a, **kw: calls.append(1) or f(*a, **kw), tview.pq_topk))
    answers = core.run_queries([(images[:3], 5)])[0]["results"]
    assert len(calls) == 2                  # one bucket of 4; QE: 2
    _, want = idx.query_images(images[:3])
    _, exact = idx.query_images(images[:3],
                                idx.cfg.search.replace(pq_depth=0))
    np.testing.assert_array_equal(want, exact)
    for row, ids in zip(answers, want):
        assert [r["id"] for r in row] == ids.tolist()
