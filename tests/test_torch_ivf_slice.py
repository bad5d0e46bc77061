"""``configs/capacity_ivfpq.json`` end to end against the JAX Index on the
mini fixture: images -> ResNet-18 -> GeM -> whitening -> int4 store ->
``build_ivfpq`` -> ``ServeCore``. The preset as loaded, cut to the fixture's
size: 64 px, f32 extraction, whitening to 16 dims, ResNet-18 for ResNet-50
(one seeded torch ResNet-18's weights on both sides), row tile 8, and a view
of 4 clusters, m = 4, depth 24 for the fixture's 56 rows. Both sides decode
the database through their native decoders (the same source).

What is compared, and the tolerances:
  * ``same``: a port index over the rows the JAX build stored, with the JAX
    build's IVF-PQ view loaded from its saved form; its ``search`` (αQE
    through the cascade) on the JAX extraction's query descriptors: scores
    within 1e-6, ids equal but at near-ties;
  * the port's own ``Index.build`` and ``build_ivfpq`` (with the JAX
    build's whitening, since each PCA may flip an eigenvector's sign):
    every query's top-1 that of JAX's ``query_images``, and ``ServeCore``
    answering requests with the same top-1 names;
  * the PQ cascade with the regional re-rank over the JAX view's codes,
    against the JAX Index: scores within 1e-5, ids equal but at near-ties;
  * the sharded IVF-PQ cascade on four CPU shards: equal to the single
    device, with and without αQE, and through ``ServeCore(sharded=True)``.
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instsearch_tpu.config import PipelineConfig as JaxPipelineConfig
from instsearch_tpu.eval import make_mini_dataset
from instsearch_tpu.index import Index as JaxIndex
from instsearch_tpu.models import load_torch_resnet
from instsearch_tpu.serve import ServeCore as JaxServeCore
from instsearch_torch import PipelineConfig
from instsearch_torch.data import frontend
from instsearch_torch.index import Index, attach_regional_store
from instsearch_torch.ops.whitening import WhiteningParams
from instsearch_torch.parallel import make_mesh
from instsearch_torch.search.ivfpq import IVFPQView
from instsearch_torch.search.pq_view import PQView
from instsearch_torch.serve import ServeCore

from parity.torch_models import BasicBlock, TruncatedResNet, randomize_bn_stats

SIZE = 64
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VIEW = dict(n_clusters=4, m=4, pq_iters=4, depth=24, cap_factor=1.0)


def _shrunk() -> str:
    cfg = JaxPipelineConfig.load(os.path.join(ROOT, "configs",
                                              "capacity_ivfpq.json"))
    cfg = cfg.replace(
        extract=cfg.extract.replace(backbone="resnet18", image_size=SIZE,
                                    whiten_dim=16, dtype="float32",
                                    batch_size=8),
        index=cfg.index.replace(row_tile=8))
    return cfg.to_json()


@pytest.fixture(scope="module")
def rig(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ivf_slice")
    ds = make_mini_dataset(str(tmp / "data"), seed=11, size=SIZE)
    torch.manual_seed(0)
    variables = load_torch_resnet(randomize_bn_stats(TruncatedResNet(
        layers=(2, 2, 2, 2), block=BasicBlock)).state_dict())
    build_from = JaxIndex.from_descriptors.__func__
    seen = {}

    def rows(cls, descriptors, *a, **kw):
        seen["rows"] = np.array(descriptors, np.float32)
        seen["kept"] = kw.get("original_ids")
        return build_from(cls, descriptors, *a, **kw)

    qimgs = np.stack([frontend.load_square(p, SIZE) for p in ds.query_paths])
    jcfg = JaxPipelineConfig.from_json(_shrunk())
    tcfg = PipelineConfig.from_json(_shrunk())
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxIndex, "from_descriptors", classmethod(rows))
        jidx = JaxIndex.build(ds.db_paths, jcfg, variables=variables)
        jidx.build_ivfpq(**VIEW)
        jidx.ivfpq.save(str(tmp / "view"))
        line = json.dumps({"images": ds.query_paths[:3]})
        jserve = JaxServeCore(jidx).handle_line(line)
    jw = jidx.extractor.whitening
    white = WhiteningParams(torch.tensor(np.asarray(jw.P)),
                            torch.tensor(np.asarray(jw.mu)))
    own = Index.build(ds.db_paths, tcfg, variables=variables,
                      whitening=white, device="cpu")
    own.build_ivfpq(**VIEW)
    same = Index.from_descriptors(seen["rows"], jidx.names, tcfg,
                                  extractor=own.extractor,
                                  original_ids=seen["kept"])
    same.ivfpq = IVFPQView.load(str(tmp / "view"), device="cpu")
    jq = np.asarray(jidx.extractor(qimgs))
    return dict(ds=ds, qimgs=qimgs, jidx=jidx, own=own, same=same, cfg=tcfg,
                jq=jq, rows=seen["rows"], jsearch=jidx.search(jq),
                jimages=jidx.query_images(qimgs), line=line, jserve=jserve)


def _assert_ranked(js, ji, ts, ti, tol):
    js, ji = np.asarray(js), np.asarray(ji)
    np.testing.assert_array_equal(np.isfinite(ts), np.isfinite(js))
    fin = np.isfinite(js)
    np.testing.assert_allclose(ts[fin], js[fin], rtol=0, atol=tol)
    for r in range(ji.shape[0]):
        score = dict(zip(ji[r].tolist(), js[r].tolist()))
        for a, b in zip(ti[r].tolist(), ji[r].tolist()):
            if a != b:
                assert a in score and abs(score[a] - score[b]) < tol, (r, a, b)


def test_preset_is_the_ivfpq_tier(rig):
    cfg = rig["cfg"]
    assert cfg.index.dtype == "int4" and cfg.search.ivfpq_nprobe == 32
    assert cfg.search.qe_enabled
    own = rig["own"]
    assert own.ivfpq is not None and own.cfg.search.ivfpq_nprobe == 32
    assert own.stats()["ivfpq"]["n_clusters"] == 4


def test_search_matches_jax(rig):
    js, ji = rig["jsearch"]
    ts, ti = rig["same"].search(rig["jq"])
    _assert_ranked(js, ji, ts, ti, 1e-6)
    es, ei = rig["same"].search(rig["jq"], rig["cfg"].search.replace(
        qe_enabled=False))
    ws, wi = rig["jidx"].search(rig["jq"], rig["jidx"].cfg.search.replace(
        qe_enabled=False))
    _assert_ranked(ws, wi, es, ei, 1e-6)


def test_own_build_answers_like_jax(rig):
    _, want = rig["jimages"]
    _, got = rig["own"].query_images(rig["qimgs"])
    np.testing.assert_array_equal(got[:, 0], np.asarray(want)[:, 0])
    ans = ServeCore(rig["own"]).handle_line(rig["line"])
    assert [r[0]["name"] for r in ans["results"]] == [
        r[0]["name"] for r in rig["jserve"]["results"]]
    assert rig["own"].ivfpq.spill_pos.shape[0] == 4096    # reserved


def test_pq_cascade_with_rerank_matches_jax(rig):
    """Re-rank under the PQ cascade (the ported stage) over the JAX view's
    codes and one regional store, both on the oracle route."""
    rows = rig["rows"]
    n = len(rows)
    jcfg = JaxPipelineConfig.from_json(rig["cfg"].to_json())
    jcfg = jcfg.replace(index=jcfg.index.replace(dtype="float32"),
                        search=jcfg.search.replace(
                            use_pallas=False, ivfpq_nprobe=0,
                            qe_enabled=True, qe_n=3))
    names = [f"r{i}" for i in range(n)]
    rng = np.random.default_rng(5)
    reg = rng.standard_normal((n, 3, 16)).astype(np.float32)
    reg /= np.linalg.norm(reg, axis=2, keepdims=True)
    qreg = rng.standard_normal((4, 3, 16)).astype(np.float32)
    jidx = JaxIndex.from_descriptors(rows, names, jcfg)
    n_pad = jidx.descriptors.shape[0]
    jidx.regional = jnp.asarray(np.pad(reg, ((0, n_pad - n), (0, 0),
                                             (0, 0))))
    jpq = jidx.build_pq(m=4, iters=4, depth=20)
    tidx = Index.from_descriptors(
        rows, names, PipelineConfig.from_json(jcfg.to_json()), device="cpu")
    attach_regional_store(tidx, reg)
    tidx.pq = PQView.from_arrays(np.asarray(jpq.codebook.centroids),
                                 np.asarray(jpq.codes), depth=20,
                                 device="cpu")
    tidx.cfg = tidx.cfg.replace(search=tidx.cfg.search.replace(pq_depth=20))
    q = rows[:4] + 0.05 * rng.standard_normal((4, 16)).astype(np.float32)
    for depth in (10, 20):
        rr = dict(rerank_enabled=True, rerank_depth=depth)
        js, ji = jidx.search(q, jidx.cfg.search.replace(**rr),
                             query_regional=qreg)
        ts, ti = tidx.search(q, tidx.cfg.search.replace(**rr),
                             query_regional=qreg)
        _assert_ranked(js, ji, ts, ti, 1e-5)


def test_sharded_ivfpq_equals_single_device(rig):
    own = rig["own"]
    mesh = make_mesh(4, devices=["cpu"] * 4)
    sidx = own.to_sharded(mesh=mesh)
    q = own.extractor(rig["qimgs"])
    s1, i1 = own.search(q, own.cfg.search.replace(qe_enabled=False))
    ss, si = (t.numpy() for t in sidx.search_ivfpq(q, k=10))
    np.testing.assert_array_equal(si, i1)
    np.testing.assert_allclose(ss, s1, rtol=0, atol=1e-6)
    for a, b in zip(own.search_sharded(sidx, q), own.search(q)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    for a, b in zip(own.query_images(rig["qimgs"], sharded_index=sidx),
                    own.query_images(rig["qimgs"])):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    sub = own.make_subset(names=own.names[::2])
    a = own.search_sharded(sidx, q, subset=sub)
    b = own.search(q, subset=sub)
    np.testing.assert_array_equal(a[1], b[1])
    assert ServeCore(own, sharded=True, mesh=mesh).handle_line(
        rig["line"])["results"] == ServeCore(own).handle_line(
        rig["line"])["results"]
