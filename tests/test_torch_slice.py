"""The ported slice end to end against the JAX Index on the mini fixture:
images -> ResNet-18 (the same variables on both sides) -> GeM -> PCA
whitening (each side fits its own) -> bf16 store -> top-k -> mAP, and the
serving core on top.

Both sides decode the database through their native C++ decoders (one
source, so the same pixels; query images through cv2). Extraction runs in
f32.

Tolerances. The two sides' whitened f32 descriptors agree to about 1e-5
(two eigensolvers, f32 and f64, and two summation orders), but a component
that lies that close to a bf16 rounding boundary rounds the other way when
stored, which moves a score by up to one bf16 ulp of the component times the
query's component: at most about 1e-3 for the ~0.13-sized components of a
55-dim unit row, and measured up to 2e-4, since the roundings of many
components partly cancel. So top-k ids must be equal, except where the JAX
scores of the two ids differ by less than 5e-4, and scores agree to 5e-4:
above the 2e-4 measured, below the one-ulp bound. mAP agrees within 0.1
points, as in
tests/parity/test_pipeline_oracle.py.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instsearch_tpu.config import (ExtractConfig, IndexConfig, PipelineConfig,
                                   SearchConfig)
from instsearch_tpu.eval import make_mini_dataset
from instsearch_tpu.index import Index as JaxIndex
from instsearch_tpu.models import load_torch_resnet
from instsearch_torch.data import frontend
from instsearch_torch.index import Index
from instsearch_torch.parallel import make_mesh
from instsearch_torch.search.pq_view import PQView
from instsearch_torch.serve import ServeCore

from parity.torch_models import BasicBlock, TruncatedResNet, randomize_bn_stats

SIZE = 64
NEAR_TIE = 5e-4
CFG = PipelineConfig(
    extract=ExtractConfig(backbone="resnet18", pooling="gem", image_size=SIZE,
                          whiten=True, dtype="float32", batch_size=16),
    index=IndexConfig(dtype="bfloat16"),
    search=SearchConfig(k=10))


@pytest.fixture(scope="module")
def rig(tmp_path_factory):
    ds = make_mini_dataset(str(tmp_path_factory.mktemp("slice")), seed=9,
                           size=SIZE)
    torch.manual_seed(0)
    tm = randomize_bn_stats(TruncatedResNet(layers=(2, 2, 2, 2),
                                            block=BasicBlock))
    variables = load_torch_resnet(tm.state_dict())
    jidx = JaxIndex.build(ds.db_paths, CFG, variables=variables)
    jmap = jidx.evaluate(ds)["mAP"]
    tidx = Index.build(ds.db_paths, CFG, variables=variables, device="cpu")
    qimgs = np.stack([frontend.load_square(p, SIZE) for p in ds.query_paths])
    return ds, jidx, jmap, tidx, qimgs


def _assert_topk_agree(js, ji, ti):
    """Equal ids, except at positions where JAX itself scores the two ids
    within NEAR_TIE of each other."""
    for q in range(ji.shape[0]):
        jscore = dict(zip(ji[q].tolist(), js[q].tolist()))
        for a, b in zip(ji[q], ti[q]):
            if a != b:
                assert b in jscore, (q, a, b)
                assert abs(jscore[a] - jscore[b]) < NEAR_TIE, (q, a, b)


def test_build_matches_layout(rig):
    ds, jidx, _, tidx, _ = rig
    assert tidx.num_valid == jidx.num_valid == len(ds.imlist)
    # the port's rows carry zero columns past the reference's width, up to
    # the width its kernels read
    rows, width = jidx.descriptors.shape
    assert tidx.descriptors.shape[0] == rows and tidx.dim == jidx.dim == width
    assert tidx.descriptors.shape[1] == tidx.store_dim >= width
    assert not tidx.descriptors[:, width:].any()
    assert tidx.names == jidx.names
    np.testing.assert_array_equal(tidx.ids.numpy(), np.asarray(jidx.ids))


def test_query_images_topk_matches_jax(rig):
    _, jidx, _, tidx, qimgs = rig
    js, ji = jidx.query_images(qimgs)
    ts, ti = tidx.query_images(qimgs)
    _assert_topk_agree(np.asarray(js), np.asarray(ji), ti)
    np.testing.assert_allclose(ts, np.asarray(js), rtol=0, atol=NEAR_TIE)


def test_evaluate_map_matches_jax(rig):
    ds, _, jmap, tidx, _ = rig
    res = tidx.evaluate(ds)
    assert res["num_queries"] == len(ds.qimlist)
    assert res["mAP"] == pytest.approx(jmap, abs=0.1), (res["mAP"], jmap)


def test_oracle_route_matches_kernel_route(rig):
    """An index whose own config has use_pallas off ranks through the
    scoring oracle instead of the kernel's path; both give the same
    answer."""
    _, _, _, tidx, qimgs = rig
    q = tidx.extractor(qimgs)
    s1, i1 = tidx.search(q)
    s2, i2 = tidx.with_search(use_pallas=False).search(q)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_allclose(s1, s2, rtol=1e-5, atol=1e-6)


def _count_calls(monkeypatch, module, name):
    calls = []
    fn = getattr(module, name)

    def counted(*a, **kw):
        calls.append(name)
        return fn(*a, **kw)

    monkeypatch.setattr(module, name, counted)
    return calls


def test_route_is_the_index_config(rig, monkeypatch):
    """The kernel entry the Index calls runs when the index's own config
    has use_pallas on, and only then: a search argument with use_pallas off
    still takes the kernel (as the reference, instsearch_tpu/index.py
    Index._topk, reads self.cfg), while the oracle twin reaches
    search_topk and never the kernel."""
    import instsearch_torch.index as tindex
    _, _, _, tidx, qimgs = rig
    q = tidx.extractor(qimgs[:2])
    kernel = _count_calls(monkeypatch, tindex, "topk_matmul")
    oracle = _count_calls(monkeypatch, tindex, "search_topk")
    tidx.search(q)
    assert (len(kernel), len(oracle)) == (1, 0)
    tidx.search(q, CFG.search.replace(use_pallas=False))
    assert (len(kernel), len(oracle)) == (2, 0)
    tidx.with_search(use_pallas=False).search(q)
    assert (len(kernel), len(oracle)) == (2, 1)


def test_query_dispatches_images_and_descriptors(rig):
    _, _, _, tidx, qimgs = rig
    s_img, i_img = tidx.query_images(qimgs[:1])
    s, i = tidx.query(qimgs[0], k=5)                   # one uint8 image
    np.testing.assert_array_equal(i, i_img[:, :5])
    d = tidx.extractor(qimgs[:1]).numpy()
    s, i = tidx.query(d[0])                            # one descriptor
    np.testing.assert_array_equal(i, i_img)
    with pytest.raises(ValueError):
        tidx.query(qimgs[:1].astype(np.float32))       # floats past [0, 1]


def test_serve_core_answers_like_query_images(rig):
    ds, _, _, tidx, qimgs = rig
    core = ServeCore(tidx)
    core.warmup()
    assert core.ready_info() == {"ready": True, "rows": tidx.num_valid,
                                 "dim": tidx.dim}
    _, want = tidx.query_images(qimgs[:3])
    one = core.handle_line(json.dumps({"image": ds.query_paths[0]}))
    assert [r["id"] for r in one["results"][0]] == want[0].tolist()
    three = core.handle_line(json.dumps({"images": ds.query_paths[:3]}))
    for row, ids in zip(three["results"], want):
        assert [r["id"] for r in row] == ids.tolist()
        assert all(r["name"] == tidx.name_of(r["id"]) for r in row)
    # a remove of an unknown name is answered with an error line and
    # leaves the index as it was; a registered subset filters a query
    err = core.handle_line(json.dumps({"remove": [ds.imlist[0] + "_x"]}))
    assert err == {"error": f"KeyError: \"not in index: "
                            f"['{ds.imlist[0]}_x']\""}
    assert core.ready_info()["rows"] == tidx.num_valid
    members = [tidx.name_of(i) for i in want[0][1:4].tolist()]
    ok = core.handle_line(json.dumps({"define_subset": {
        "name": "three", "members": members}}))
    assert ok["subset"] == "three" and ok["count"] == 3
    sub = core.handle_line(json.dumps({"image": ds.query_paths[0],
                                       "subset": "three"}))
    assert [r["id"] for r in sub["results"][0]] == want[0][1:4].tolist()
    bad = core.handle_line(json.dumps({"image": "/nonexistent.jpg"}))
    assert "error" in bad


def test_unported_stages_raise(rig):
    """int8, int4, QE, re-rank, refine, regional extraction, shards and
    subsets are ported (an unknown subset member raises ``KeyError``), and
    diffusion answers; l2 answers too (its top-1 for a stored row is the
    row itself, at distance 0); re-rank under the PQ cascade answers, as
    JAX's."""
    _, _, _, tidx, qimgs = rig
    q = tidx.extractor(qimgs[:1])
    s, i = tidx.search(q, CFG.search.replace(qe_enabled=True))
    assert i.shape == (1, 10) and np.isfinite(s).all()
    # re-rank without a regional store ranks as plain search, as in the
    # reference; refine without the refine store is a config error
    np.testing.assert_array_equal(
        tidx.search(q, CFG.search.replace(rerank_enabled=True))[1],
        tidx.search(q)[1])
    with pytest.raises(ValueError, match="refine store"):
        tidx.search(q, CFG.search.replace(refine_enabled=True))
    # diffusion answers (M8 is ported): its ids are among the plain
    # search's top diffusion_depth
    s, i = tidx.search(q, CFG.search.replace(diffusion_enabled=True,
                                             diffusion_depth=16))
    assert i.shape == (1, 10) and np.isfinite(s).all()
    assert set(i[0].tolist()) <= set(tidx.search(
        q, CFG.search.replace(k=16))[1][0].tolist())
    with pytest.raises(KeyError, match="subset names not in the index"):
        tidx.search(q, subset=["x"])
    s, i = tidx.search(q, subset=tidx.names[:3])
    assert sorted(i[0, :3].tolist()) == tidx.ids[:3].tolist()
    assert (i[0, 3:] == -1).all()
    reg = tidx.extractor.extract_regional(qimgs[:1])
    assert tuple(reg.shape) == (1, len(tidx.extractor.regional_geometry()),
                                tidx.dim)
    descs, regional, kept = tidx.extractor.extract_paths_with_regional([])
    assert descs.shape[0] == regional.shape[0] == kept.shape[0] == 0
    rows = np.eye(4, 8, dtype=np.float32)
    l2 = Index.from_descriptors(rows, list("abcd"), CFG.replace(
        index=IndexConfig(metric="l2")), device="cpu")
    s, i = l2.search(rows)
    assert i[:, 0].tolist() == [0, 1, 2, 3] and (s[:, 0] == 0).all()
    sharded = Index.from_descriptors(rows, list("abcd"), CFG.replace(
        index=IndexConfig(num_shards=2)), device="cpu")
    sidx = sharded.to_sharded(mesh=make_mesh(2, devices=["cpu"] * 2))
    assert sidx.search(rows)[1][:, 0].tolist() == [0, 1, 2, 3]
    for icfg in (IndexConfig(dtype="int8"), IndexConfig(dtype="int4"),
                 IndexConfig(dtype="int4", refine_dtype="int8")):
        idx = Index.from_descriptors(rows, list("abcd"), CFG.replace(
            index=icfg, search=CFG.search.replace(
                refine_enabled=bool(icfg.refine_dtype))), device="cpu")
        assert idx.search(rows)[1][:, 0].tolist() == [0, 1, 2, 3]
    many = np.random.default_rng(0).standard_normal((64, 8)).astype(
        np.float32)
    pq = Index.from_descriptors(many, [f"r{i}" for i in range(64)], CFG,
                                device="cpu")
    pq.build_pq(m=2, iters=2, depth=16)
    pq.regional = torch.zeros((pq.descriptors.shape[0], 1, 8))
    # re-rank under the PQ cascade (ported since ROADMAP M9): over the JAX
    # view's codes, on the oracle route, JAX's answer
    jpq = JaxIndex.from_descriptors(many, [f"r{i}" for i in range(64)], CFG)
    jview = jpq.build_pq(m=2, iters=2, depth=16)
    jpq.regional = jnp.zeros((jpq.descriptors.shape[0], 1, 8), jnp.bfloat16)
    pq.pq = PQView.from_arrays(np.asarray(jview.codebook.centroids),
                               np.asarray(jview.codes), depth=16,
                               device="cpu")
    rcfg = CFG.search.replace(rerank_enabled=True, rerank_depth=12,
                              pq_depth=16)
    js, ji = jpq.search(many[:2], rcfg, query_regional=many[:2, None, :])
    ts, ti = pq.with_search(use_pallas=False).search(
        many[:2], rcfg, query_regional=many[:2, None, :])
    np.testing.assert_array_equal(ti, np.asarray(ji))
    np.testing.assert_allclose(ts, np.asarray(js), rtol=0, atol=1e-5)
