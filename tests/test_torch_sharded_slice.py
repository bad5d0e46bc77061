"""The sharded presets end to end against the JAX Index on the mini fixture:
``configs/oxford105k_sharded8.json`` (bf16, 8 shards), ``million_scale_int8
.json`` (int8 with alpha-QE, 8 shards) and ``spatial_rerank_top100.json``
(VGG16 R-MAC, bf16, the regional re-rank with the spatial vote, 2 shards),
as loaded and cut to this fixture's size: 96 px, f32 extraction, whitening
to 16 dims, row tile 8 (so the 40 images fill several shards; at 8 shards
the last one is all padding), and ResNet-18 for ResNet-50 (the weights of a
seeded torch ResNet-18 on both sides, as test_torch_slice.py). Both sides
decode the JPEG files through their native decoders (the same source). Cut
so, the two ResNet presets extract alike: JAX's int8 index is built over
the rows of its bf16 build's one extraction.

The port's own ``Index.build`` of each preset (with the JAX build's
whitening fit: each side's PCA may flip an eigenvector's sign) goes through
``to_sharded`` on ``["cpu"] * S``: its sharded answers equal its
single-device ones exactly, ``query_images``, ``evaluate`` and
``ServeCore`` alike. Against JAX's calls (``to_sharded()`` over the virtual
devices of tests/conftest.py, whose CPU route is the oracle) the port runs
``same``, an index over the rows and regional rows the JAX build stored
(byte-equal stores), on the oracle route too: only the query descriptors
differ, by the two extractors' ~1e-6, but a bf16 store scores the query
rounded to bf16, where such a difference can move a component by one bf16
step: so ids are equal except where JAX's own scores of the two ids are
within NEAR_TIE = 5e-4 of each other, and scores agree to NEAR_TIE (the
bound of test_torch_slice.py); mAP within 0.1 points.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import instsearch_tpu.index as jindex
from instsearch_tpu.config import PipelineConfig as JaxPipelineConfig
from instsearch_tpu.eval import make_mini_dataset
from instsearch_tpu.index import Index as JaxIndex
from instsearch_tpu.models import load_torch_resnet
from instsearch_tpu.models.vgg import vgg16 as jax_vgg16
from instsearch_tpu.serve import ServeCore as JaxServeCore
from instsearch_torch import PipelineConfig
from instsearch_torch.data import frontend
from instsearch_torch.extractor import Extractor
from instsearch_torch.index import Index, attach_regional_store
from instsearch_torch.ops.whitening import WhiteningParams
from instsearch_torch.parallel import make_mesh
from instsearch_torch.search.ivfpq import IVFPQView
from instsearch_torch.serve import ServeCore

from parity.torch_models import BasicBlock, TruncatedResNet, randomize_bn_stats

SIZE = 96
NEAR_TIE = 5e-4
PRESETS = ("oxford105k_sharded8", "million_scale_int8",
           "spatial_rerank_top100")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _shrunk(preset: str) -> str:
    """The preset's JSON, cut to the fixture's size."""
    cfg = JaxPipelineConfig.load(os.path.join(ROOT, "configs",
                                              preset + ".json"))
    resnet = cfg.extract.backbone == "resnet50"
    cfg = cfg.replace(
        extract=cfg.extract.replace(
            backbone="resnet18" if resnet else cfg.extract.backbone,
            image_size=SIZE, whiten_dim=16, dtype="float32", batch_size=8),
        index=cfg.index.replace(row_tile=8))
    return cfg.to_json()


def _port_side(jidx, cfg, seen, variables, paths):
    """The port's own build of ``cfg`` (with JAX's whitening) and ``same``,
    a port index over the rows the JAX build stored."""
    jw = jidx.extractor.whitening
    white = WhiteningParams(torch.tensor(np.asarray(jw.P)),
                            torch.tensor(np.asarray(jw.mu)))
    own = Index.build(paths, cfg, variables=variables, whitening=white,
                      device="cpu")
    ex = Extractor(cfg.extract.replace(whiten=False), variables,
                   whitening=white, device="cpu")
    same = Index.from_descriptors(seen["rows"], jidx.names, cfg, extractor=ex,
                                  original_ids=seen["kept"])
    if "regional" in seen:
        attach_regional_store(same, seen["regional"])
    return own, same


@pytest.fixture(scope="module")
def rig(tmp_path_factory):
    ds = make_mini_dataset(str(tmp_path_factory.mktemp("sharded_slice")),
                           seed=9, size=SIZE)
    torch.manual_seed(0)
    resnet = load_torch_resnet(randomize_bn_stats(TruncatedResNet(
        layers=(2, 2, 2, 2), block=BasicBlock)).state_dict())
    vgg = jax.tree_util.tree_map(np.asarray, jax_vgg16(jnp.float32).init(
        jax.random.PRNGKey(0), np.zeros((1, SIZE, SIZE, 3), np.float32)))
    build_from = JaxIndex.from_descriptors.__func__
    attach = jindex.attach_regional_store
    seen = {}

    def rows(cls, descriptors, *a, **kw):
        seen["rows"] = np.array(descriptors, np.float32)
        seen["kept"] = kw.get("original_ids")
        return build_from(cls, descriptors, *a, **kw)

    def regional(idx, reg):
        seen["regional"] = np.array(reg, np.float32)
        return attach(idx, reg)

    out = {"ds": ds, "qimgs": np.stack([frontend.load_square(p, SIZE)
                                        for p in ds.query_paths])}
    extracted = {}      # the two ResNet presets share one JAX extraction
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxIndex, "from_descriptors", classmethod(rows))
        mp.setattr(jindex, "attach_regional_store", regional)
        for preset in PRESETS:
            jcfg = JaxPipelineConfig.from_json(_shrunk(preset))
            tcfg = PipelineConfig.from_json(_shrunk(preset))
            variables = resnet if tcfg.extract.backbone == "resnet18" else vgg
            key = jcfg.extract.to_json()
            if key in extracted:
                prev, prev_seen = extracted[key]
                jidx = JaxIndex.from_descriptors(
                    prev_seen["rows"], prev.names, jcfg,
                    extractor=prev.extractor,
                    original_ids=prev_seen["kept"])
            else:
                seen.clear()
                jidx = JaxIndex.build(ds.db_paths, jcfg, variables=variables)
                extracted[key] = (jidx, dict(seen))
            own, same = _port_side(jidx, tcfg, extracted[key][1], variables,
                                   ds.db_paths)
            jsidx = jidx.to_sharded()
            out[preset] = dict(
                jidx=jidx, own=own, same=same, cfg=tcfg,
                jq=jidx.query_images(out["qimgs"], sharded_index=jsidx),
                jeval=jidx.evaluate(ds, sharded=True),
                jserve=JaxServeCore(jidx, sharded=True).handle_line(
                    json.dumps({"images": ds.query_paths[:3]})))
    return out


def _mesh(idx):
    s = idx.cfg.index.num_shards
    return make_mesh(s, devices=["cpu"] * s)


def _assert_topk_agree(js, ji, ts, ti):
    """Equal ids, except at slots where JAX itself scores the two ids
    within NEAR_TIE of each other; scores within NEAR_TIE."""
    js, ji = np.asarray(js), np.asarray(ji)
    assert ti.shape == ji.shape
    for q in range(ji.shape[0]):
        jscore = dict(zip(ji[q].tolist(), js[q].tolist()))
        for a, b in zip(ji[q], ti[q]):
            if a != b:
                assert b in jscore, (q, a, b)
                assert abs(jscore[a] - jscore[b]) < NEAR_TIE, (q, a, b)
    np.testing.assert_allclose(ts, js, rtol=0, atol=NEAR_TIE)


@pytest.mark.parametrize("preset", PRESETS)
def test_presets_build_sharded(rig, preset):
    """``Index.build`` takes the preset's shard count: the store pads to
    ``row_tile * num_shards`` and ``to_sharded`` cuts it into views."""
    r = rig[preset]
    own, cfg = r["own"], r["cfg"]
    s = cfg.index.num_shards
    assert s == {"spatial_rerank_top100": 2}.get(preset, 8)
    assert own.descriptors.shape[0] % (8 * s) == 0
    assert own.descriptors.shape[0] == r["jidx"].descriptors.shape[0]
    sidx = own.to_sharded(mesh=_mesh(own))
    assert sidx.mesh.num_shards == s and sidx.num_valid == own.num_valid
    assert (sidx.regional is not None) == cfg.search.rerank_enabled
    base = own.descriptors.untyped_storage().data_ptr()
    assert all(sh.x.untyped_storage().data_ptr() == base
               for sh in sidx.shards)


@pytest.mark.parametrize("preset", PRESETS)
def test_query_images_sharded_matches_jax(rig, preset):
    r = rig[preset]
    same = r["same"].with_search(use_pallas=False)
    ts, ti = same.query_images(
        rig["qimgs"], sharded_index=same.to_sharded(mesh=_mesh(same)))
    _assert_topk_agree(*r["jq"], ts, ti)


@pytest.mark.parametrize("preset", PRESETS)
def test_query_images_sharded_equals_single_device(rig, preset):
    """The port's own build on the kernel route (the presets' route; the
    kernels' plain versions on the CPU): the sharded route equals the
    single-device one, ids and scores, and every query's top-1 is the
    same."""
    own = rig[preset]["own"]
    sidx = own.to_sharded(mesh=_mesh(own))
    assert sidx.use_pallas
    ts, ti = own.query_images(rig["qimgs"], sharded_index=sidx)
    ws, wi = own.query_images(rig["qimgs"])
    np.testing.assert_array_equal(ti, wi)
    np.testing.assert_array_equal(ts, ws)
    assert np.isfinite(ts).all()


@pytest.mark.parametrize("preset", PRESETS)
def test_evaluate_sharded_matches_jax(rig, preset):
    r = rig[preset]
    same = r["same"].with_search(use_pallas=False)
    res = same.evaluate(rig["ds"], sharded=True, mesh=_mesh(same))
    want = r["jeval"]
    assert res["stages_applied"] == want["stages_applied"]
    assert res["mAP"] == pytest.approx(want["mAP"], abs=0.1), \
        (res["mAP"], want["mAP"])
    single = same.evaluate(rig["ds"])
    assert res["mAP"] == single["mAP"]
    assert res["stages_applied"] == single["stages_applied"]


@pytest.mark.parametrize("preset", PRESETS)
def test_serve_core_sharded(rig, preset):
    """``ServeCore(sharded=True)``: ``handle_line`` answers as the JAX
    ServeCore's sharded view does (``same``, oracle route), and as
    ``query_images`` through the sharded index (the port's own build);
    ``ready_info`` names the shards."""
    r = rig[preset]
    ds = rig["ds"]
    line = json.dumps({"images": ds.query_paths[:3]})
    same = r["same"].with_search(use_pallas=False)
    core = ServeCore(same, sharded=True, mesh=_mesh(same))
    core.warmup()
    got = core.handle_line(line)["results"]
    want = r["jserve"]["results"]
    _assert_topk_agree([[x["score"] for x in row] for row in want],
                       [[x["id"] for x in row] for row in want],
                       np.array([[x["score"] for x in row] for row in got]),
                       np.array([[x["id"] for x in row] for row in got]))
    own = r["own"]
    core = ServeCore(own, sharded=True, mesh=_mesh(own))
    assert core.ready_info() == {"ready": True, "rows": own.num_valid,
                                 "dim": own.dim,
                                 "shards": own.cfg.index.num_shards}
    _, ids = own.query_images(rig["qimgs"][:3], sharded_index=core.sidx)
    three = core.handle_line(line)
    for row, want_ids in zip(three["results"], ids):
        assert [x["id"] for x in row] == want_ids.tolist()
        assert all(x["name"] == own.name_of(x["id"]) for x in row)


def test_refusals(rig, monkeypatch, tmp_path):
    """``make_mesh(8)`` and ``to_sharded()`` on one device raise rather
    than shrink; subset masks are taken (a mask of another size and an
    unknown member refused); range search, not ported yet, raises
    ``NotImplementedError`` naming its ROADMAP item; the IVF-PQ cascade
    (ported since ROADMAP M9) answers over JAX's view as JAX's sharded
    index does, and as one device; the quality tiers' stages answer."""
    own = rig["oxford105k_sharded8"]["own"]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="8 shards, have 1"):
        make_mesh(8)
    with pytest.raises(ValueError, match="8 shards, have 1"):
        own.to_sharded()
    with pytest.raises(ValueError, match="requested 4 shards"):
        make_mesh(4, devices=["cpu"] * 8)
    sidx = own.to_sharded(mesh=_mesh(own))
    q = own.extractor(rig["qimgs"][:1])
    everyone = np.ones((1, own.descriptors.shape[0]), np.int8)
    for a, b in zip(sidx.search(q, mask=everyone), sidx.search(q)):
        assert torch.equal(a, b)
    assert sidx.place_subset(None) is None
    with pytest.raises(ValueError, match="different store"):
        sidx.search_qe(q, mask=np.ones((1, 8), np.int8))
    with pytest.raises(KeyError, match="subset names not in the index"):
        own.query_images(rig["qimgs"][:1], sharded_index=sidx, subset=["x"])
    with pytest.raises(NotImplementedError, match="M7"):
        sidx.search_range(q, 0.5)
    with pytest.raises(ValueError, match="no IVF-PQ view attached"):
        sidx.search_ivfpq(q)
    r = rig["oxford105k_sharded8"]
    jidx = r["jidx"]
    jtwin = JaxIndex(jidx.descriptors, jidx.ids, jidx.names, jidx.cfg)
    jtwin.build_ivfpq(n_clusters=4, nprobe=2, m=4, pq_iters=3, depth=20)
    jtwin.ivfpq.save(str(tmp_path))
    same = r["same"].with_search()
    same.ivfpq = IVFPQView.load(str(tmp_path), device="cpu")
    psidx = same.to_sharded(mesh=_mesh(same))
    jq = np.asarray(jidx.extractor(rig["qimgs"][:3]))
    ts, ti = (t.numpy() for t in psidx.search_ivfpq(jq, k=10))
    js, ji = jtwin.to_sharded().search_ivfpq(jnp.asarray(jq), k=10)
    _assert_topk_agree(np.asarray(js), np.asarray(ji), ts, ti)
    ws, wi = same.search(jq, same.cfg.search.replace(ivfpq_nprobe=2))
    np.testing.assert_array_equal(ti, wi)
    np.testing.assert_allclose(ts, ws, rtol=0, atol=1e-6)
    # the quality tiers answer (M8 is ported): diffusion as the single
    # device, the database-side expansion unit rows, local whitening after
    # a fit (without one, a ValueError names it)
    dcfg = own.cfg.search.replace(diffusion_enabled=True)
    for a, b in zip(own.search_sharded(sidx, q, dcfg), own.search(q, dcfg)):
        np.testing.assert_array_equal(a, b)
    rows = sidx.expand_queries(q, include_query=False)
    torch.testing.assert_close(rows.norm(dim=1), torch.ones(1))
    with pytest.raises(ValueError, match="no local-whitening view"):
        sidx.search_lw(q)
