"""The ViT slice end to end against the JAX Index on the mini fixture: images
-> tiny ViT (the same variables on both sides, registered in both
registries as the reference's own test does, tests/unit/test_vit_backbone.py)
-> GeM -> PCA whitening (each side fits its own) -> bf16 store -> top-k ->
mAP, on the port's three attention routes, and the serving core on top.

Both sides decode with cv2 (the JAX frontend's native decoder is switched
off, as in tests/test_torch_slice.py). Extraction runs in f32; the JAX side
takes its plain route (``vit_attention="xla"``), which its own tests hold to
its kernel routes within 2e-5.

Tolerances. Unwhitened descriptors: 2e-5, the backbone's f32 bar
(tests/test_torch_vit.py); the pooled, L2-normalized vectors inherit it.
Top-k and scores: NEAR_TIE = 5e-4, the rule of tests/test_torch_slice.py (a
whitened component next to a bf16 rounding boundary rounds the other way in
the store, up to about 1e-3, measured below 2e-4): ids equal except where
JAX's own scores of the two ids differ by less than NEAR_TIE. mAP within 0.1
points. Whitening keeps 16 of the 32 dims: fitted on 32 descriptors of 32
dims, the last eigenvalues are near zero, and their 1/sqrt(eigenvalue)
magnifies the sides' 1e-6 descriptor differences past NEAR_TIE (1.3e-3
measured at full rank).
"""
import json

import numpy as np
import pytest
import torch

import instsearch_tpu.models.registry as jreg
from instsearch_tpu.config import (ExtractConfig as JaxExtractConfig,
                                   IndexConfig as JaxIndexConfig,
                                   PipelineConfig as JaxPipelineConfig,
                                   SearchConfig as JaxSearchConfig)
from instsearch_tpu.data import native_frontend
from instsearch_tpu.eval import make_mini_dataset
from instsearch_tpu.extractor import Extractor as JaxExtractor
from instsearch_tpu.index import Index as JaxIndex
from instsearch_tpu.models import load_torch_vit
from instsearch_tpu.models.vit import ViT as JaxViT
import instsearch_torch.kernels.vit_attention as tva
import instsearch_torch.models.registry as treg
from instsearch_torch import (ExtractConfig, IndexConfig, PipelineConfig,
                              SearchConfig)
from instsearch_torch.data import frontend
from instsearch_torch.extractor import Extractor
from instsearch_torch.index import Index
from instsearch_torch.models.vit import ViT
from instsearch_torch.serve import ServeCore

from test_torch_vit import TINY, tiny_variables

SIZE = 64
NEAR_TIE = 5e-4
NAME = "vit_tiny"
ROUTES = ("xla", "pallas", "flash")


def _jax_factory(dtype=None, attention="auto"):
    return JaxViT(dtype=dtype, attention=attention, **TINY)


def _port_factory(dtype=torch.bfloat16, attention="auto", device=None):
    return ViT(dtype=dtype, attention=attention, device=device, **TINY)


def _extract_cfg(cls, attention="xla", whiten=True):
    return cls(backbone=NAME, pooling="gem", image_size=SIZE, whiten=whiten,
               whiten_dim=16, dtype="float32", batch_size=16,
               vit_attention=attention)


def _port_cfg(attention):
    return PipelineConfig(extract=_extract_cfg(ExtractConfig, attention),
                          index=IndexConfig(dtype="bfloat16"),
                          search=SearchConfig(k=10))


@pytest.fixture(scope="module")
def registered():
    """The tiny ViT under one name in both registries, for the module."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jreg.BACKBONES, NAME,
                   jreg.BackboneSpec(_jax_factory, 32, 4, load_torch_vit))
        mp.setitem(treg.BACKBONES, NAME,
                   treg.BackboneSpec(_port_factory, 32, 4))
        mp.setattr(native_frontend, "available", lambda: False)
        yield tiny_variables()


@pytest.fixture(scope="module")
def rig(registered, tmp_path_factory):
    variables = registered
    ds = make_mini_dataset(str(tmp_path_factory.mktemp("vit_slice")), seed=9,
                           size=SIZE)
    jcfg = JaxPipelineConfig(extract=_extract_cfg(JaxExtractConfig),
                             index=JaxIndexConfig(dtype="bfloat16"),
                             search=JaxSearchConfig(k=10))
    jidx = JaxIndex.build(ds.db_paths, jcfg, variables=variables)
    jmap = jidx.evaluate(ds)["mAP"]
    tidx = {a: Index.build(ds.db_paths, _port_cfg(a), variables=variables,
                           device="cpu") for a in ROUTES}
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


@pytest.mark.parametrize("attention", ROUTES)
def test_descriptors_match_jax(registered, rig, attention):
    _, _, _, _, qimgs = rig
    cfg = _extract_cfg(ExtractConfig, attention, whiten=False)
    want = np.asarray(JaxExtractor(_extract_cfg(JaxExtractConfig,
                                                whiten=False),
                                   variables=registered)(qimgs))
    got = Extractor(cfg, registered, device="cpu")(qimgs).numpy()
    assert got.shape == want.shape == (len(qimgs), 32)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("attention", ROUTES)
def test_query_images_topk_matches_jax(rig, attention):
    ds, jidx, _, tidx, qimgs = rig
    idx = tidx[attention]
    assert idx.num_valid == jidx.num_valid == len(ds.imlist)
    assert tuple(idx.descriptors.shape) == tuple(jidx.descriptors.shape)
    js, ji = jidx.query_images(qimgs)
    ts, ti = idx.query_images(qimgs)
    _assert_topk_agree(np.asarray(js), np.asarray(ji), ti)
    np.testing.assert_allclose(ts, np.asarray(js), rtol=0, atol=NEAR_TIE)


@pytest.mark.parametrize("attention", ROUTES)
def test_evaluate_map_matches_jax(rig, attention):
    ds, _, jmap, tidx, _ = rig
    res = tidx[attention].evaluate(ds)
    assert res["num_queries"] == len(ds.qimlist)
    assert res["mAP"] == pytest.approx(jmap, abs=0.1), (res["mAP"], jmap)


@pytest.mark.parametrize("attention,plain", [("xla", None),
                                             ("pallas", "mha_reference"),
                                             ("flash", "flash_mha_reference")])
def test_route_is_the_extract_config(rig, monkeypatch, attention, plain):
    """An image query runs the route its index's config names: on the CPU a
    kernel route reaches the kernel wrapper, which takes its plain version,
    once per encoder layer per backbone pass; the plain matmul route reaches
    neither."""
    _, _, _, tidx, qimgs = rig
    calls = []
    for name in ("mha_reference", "flash_mha_reference"):
        fn = getattr(tva, name)
        monkeypatch.setattr(tva, name, lambda *a, _fn=fn, _nm=name, **kw: (
            calls.append(_nm), _fn(*a, **kw))[1])
    tidx[attention].query_images(qimgs[:2])
    want = [] if plain is None else [plain] * TINY["num_layers"]
    assert calls == want


def test_serve_core_answers_like_query_images(rig):
    ds, _, _, tidx, qimgs = rig
    idx = tidx["pallas"]
    core = ServeCore(idx)
    core.warmup()
    assert core.ready_info() == {"ready": True, "rows": idx.num_valid,
                                 "dim": idx.dim}
    _, want = idx.query_images(qimgs[:3])
    three = core.handle_line(json.dumps({"images": ds.query_paths[:3]}))
    for row, ids in zip(three["results"], want):
        assert [r["id"] for r in row] == ids.tolist()
        assert all(r["name"] == idx.name_of(r["id"]) for r in row)


def test_multiscale_extractor_matches_jax(registered):
    """Multi-scale extraction over the patch grid (the position grid resized
    at each scale), as the reference's test_extractor_pipeline_with_vit:
    scales (1.0, 0.75), unit-norm descriptors, here also held to JAX's on
    the same variables."""
    kw = dict(backbone=NAME, pooling="gem", image_size=32, scales=(1.0, 0.75),
              dtype="float32", batch_size=4)
    imgs = np.random.default_rng(0).integers(0, 256, (3, 32, 32, 3),
                                             dtype=np.uint8)
    want = np.asarray(JaxExtractor(JaxExtractConfig(**kw),
                                   variables=registered)(imgs))
    got = Extractor(ExtractConfig(**kw), registered, device="cpu")(imgs)
    assert got.shape == (3, 32)
    np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=1), 1.0,
                               rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_seeded_random_extractor_runs_every_route(registered):
    """variables=None draws the ViT's seeded initializers; the three routes
    give one descriptor to f32 rounding."""
    imgs = np.random.default_rng(1).integers(0, 256, (2, 32, 32, 3),
                                             dtype=np.uint8)
    outs = [Extractor(ExtractConfig(backbone=NAME, image_size=32,
                                    dtype="float32", vit_attention=a),
                      seed=3, device="cpu")(imgs).numpy() for a in ROUTES]
    for o in outs[1:]:
        np.testing.assert_allclose(o, outs[0], rtol=2e-5, atol=2e-5)
