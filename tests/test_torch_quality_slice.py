"""The quality presets end to end against the JAX Index on the mini
fixture: ``configs/quality_ladder.json`` (three scales, αDBA at build, αQE,
diffusion at depth 200) and ``configs/local_whiten_rerank.json`` (αQE, then
the local-whitening re-score of the top 100 after
``fit_local_whitening()``), as loaded and cut to the fixture's size: 64 px,
f32 extraction, whitening to 16 dims (the fixture's 32 images would leave a
full-width fit rank-deficient), ResNet-18 for ResNet-50 (a seeded torch
ResNet-18's weights on both sides), row tile 8. Both sides decode with cv2.

What is compared, and the tolerances:
  * ``same``: a port index over the rows the JAX build stored before its
    αDBA (recorded), augmented by the port: the store within one bf16 step
    of the JAX build's; for local whitening the JAX index's view carried
    into ``same`` (one bank: test_torch_lw_rerank.py);
  * ``search`` of both on the same query descriptors (JAX's extraction):
    ids equal but at near-ties, scores within 1e-5 of the row's largest
    (diffusion's CG amplifies f32 orders; test_torch_diffusion.py) and 1e-6
    for local whitening;
  * the port's own ``Index.build`` (with the JAX build's whitening, since
    each PCA may flip an eigenvector's sign) and its own
    ``fit_local_whitening``: every query's top-1 that of JAX's
    ``query_images``, mAP within 0.1 points, ``stages_applied``;
  * its sharded routes (``to_sharded`` on ``["cpu"] * 2``):
    ``query_images``, ``evaluate`` and ``ServeCore`` equal to the
    single-device ones.
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instsearch_tpu.config import PipelineConfig as JaxPipelineConfig
from instsearch_tpu.data import native_frontend
from instsearch_tpu.eval import make_mini_dataset
from instsearch_tpu.index import Index as JaxIndex
from instsearch_tpu.models import load_torch_resnet
from instsearch_torch import PipelineConfig
from instsearch_torch.data import frontend
from instsearch_torch.index import Index
from instsearch_torch.ops.local_whiten import LocalWhiteningParams
from instsearch_torch.ops.whitening import WhiteningParams
from instsearch_torch.parallel import make_mesh
from instsearch_torch.search.lw_rerank import LocalWhiteningView
from instsearch_torch.serve import ServeCore

from parity.torch_models import BasicBlock, TruncatedResNet, randomize_bn_stats

SIZE = 64
PRESETS = ("quality_ladder", "local_whiten_rerank")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _shrunk(preset: str) -> str:
    cfg = JaxPipelineConfig.load(os.path.join(ROOT, "configs",
                                              preset + ".json"))
    cfg = cfg.replace(
        extract=cfg.extract.replace(backbone="resnet18", image_size=SIZE,
                                    whiten_dim=16, dtype="float32",
                                    batch_size=8),
        index=cfg.index.replace(row_tile=8))
    return cfg.to_json()


def _carry(jview):
    p = jview.params
    return LocalWhiteningView(
        LocalWhiteningParams(*(torch.tensor(np.asarray(t))
                               for t in (p.centroids, p.P, p.mu))),
        torch.tensor(np.asarray(jview.store.astype(jnp.float32)))
        .to(torch.bfloat16), torch.tensor(np.asarray(jview.assign)))


@pytest.fixture(scope="module")
def rig(tmp_path_factory):
    ds = make_mini_dataset(str(tmp_path_factory.mktemp("quality_slice")),
                           seed=9, size=SIZE)
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
    out = {"ds": ds, "qimgs": qimgs}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native_frontend, "available", lambda: False)
        mp.setattr(JaxIndex, "from_descriptors", classmethod(rows))
        for preset in PRESETS:
            jcfg = JaxPipelineConfig.from_json(_shrunk(preset))
            tcfg = PipelineConfig.from_json(_shrunk(preset))
            jidx = JaxIndex.build(ds.db_paths, jcfg, variables=variables)
            lw = tcfg.search.lw_enabled
            if lw:
                jidx.fit_local_whitening()
            jw = jidx.extractor.whitening
            white = WhiteningParams(torch.tensor(np.asarray(jw.P)),
                                    torch.tensor(np.asarray(jw.mu)))
            own = Index.build(ds.db_paths, tcfg, variables=variables,
                              whitening=white, device="cpu")
            same = Index.from_descriptors(seen["rows"], jidx.names, tcfg,
                                          extractor=own.extractor,
                                          original_ids=seen["kept"])
            if lw:
                own.fit_local_whitening()
                same.lw = _carry(jidx.lw)
            else:
                same.augment_database()
            jq = np.asarray(jidx.extractor(qimgs))
            out[preset] = dict(
                jidx=jidx, own=own, same=same, cfg=tcfg, jq=jq,
                jsearch=jidx.search(jq), jimages=jidx.query_images(qimgs),
                jeval=jidx.evaluate(ds))
    return out


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


def test_presets_are_the_quality_tiers(rig):
    ladder = rig["quality_ladder"]["cfg"]
    assert ladder.index.dba_n == 10 and ladder.search.diffusion_enabled
    assert ladder.search.qe_enabled and tuple(ladder.extract.scales) == (
        1.0, 0.7071, 0.5)
    lw = rig["local_whiten_rerank"]
    assert lw["cfg"].search.lw_enabled and lw["own"].lw is not None
    assert lw["own"].lw.n_clusters == lw["jidx"].lw.n_clusters


def test_augmented_store_matches_jax_build(rig):
    r = rig["quality_ladder"]
    n = r["jidx"].descriptors.shape[0]
    a = r["same"]._rows_f32_chunk(0, n).numpy()
    b = np.asarray(r["jidx"]._rows_f32_chunk(0, n))
    assert (np.abs(a - b) <= np.abs(b) * 2.0 ** -7 + 1e-7).all()
    # the port's own build augmented its store too
    own = r["own"]._rows_f32_chunk(0, n).numpy()
    assert np.abs(own - b).max() < 1e-2


@pytest.mark.parametrize("preset", PRESETS)
def test_search_matches_jax(rig, preset):
    r = rig[preset]
    js, ji = r["jsearch"]
    ts, ti = r["same"].search(r["jq"])
    scale = max(1.0, float(np.abs(np.asarray(js)[np.isfinite(js)]).max()))
    _assert_ranked(js, ji, ts, ti,
                   1e-6 if preset == "local_whiten_rerank" else 1e-5 * scale)


@pytest.mark.parametrize("preset", PRESETS)
def test_own_build_answers_like_jax(rig, preset):
    r = rig[preset]
    _, want = r["jimages"]
    _, got = r["own"].query_images(rig["qimgs"])
    np.testing.assert_array_equal(got[:, 0], np.asarray(want)[:, 0])
    res = r["own"].evaluate(rig["ds"])
    stage = "diffusion" if preset == "quality_ladder" else "lw"
    assert res["stages_applied"] == ["qe", stage] == \
        r["jeval"]["stages_applied"]
    assert res["mAP"] == pytest.approx(r["jeval"]["mAP"], abs=0.1)


@pytest.mark.parametrize("preset", PRESETS)
def test_sharded_routes_equal_single_device(rig, preset):
    own = rig[preset]["own"]
    mesh = make_mesh(2, devices=["cpu"] * 2)
    sidx = own.to_sharded(mesh=mesh)
    for a, b in zip(own.query_images(rig["qimgs"], sharded_index=sidx),
                    own.query_images(rig["qimgs"])):
        np.testing.assert_array_equal(a, b)
    ds = rig["ds"]
    assert own.evaluate(ds, sharded=True, mesh=mesh)["mAP"] == \
        own.evaluate(ds)["mAP"]
    line = json.dumps({"images": ds.query_paths[:3]})
    assert ServeCore(own, sharded=True, mesh=mesh).handle_line(line)[
        "results"] == ServeCore(own).handle_line(line)["results"]
