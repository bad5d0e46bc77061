"""Workloads 2 and 5 end to end against the JAX Index on the mini fixture:
PNG images -> VGG16 at 96 px (the same Flax variables on both sides,
carried by ``from_jax_vgg``) -> R-MAC (global descriptor and 14 regional
rows from one backbone pass) -> PCA whitening to 16 dims, global and
regional -> bf16 store plus a regional store ``[N_pad, 14, 16]`` -> K1's
top-``rerank_depth`` candidates -> region match (+ the spatial vote) -> top-k
-> mAP; the exact-refine tier over int4; the serving core on top.

Both sides decode the same lossless PNG files with cv2 (the JAX frontend's
native decoder is switched off, as in test_torch_slice.py). Extraction runs
in f32. 16 whitened dims of 56 images keep the fit well conditioned (a fit
of as many dims as images magnifies 1e-6 differences past every bar).

What is compared, and the tolerances:
  * the port's own ``Index.build`` (with the JAX build's whitening fit, since
    each side's PCA may flip an eigenvector's sign) against the JAX build:
    the global and regional stores within one bf16 step of each other plus
    ROWS_TOL = 1e-5 (the f32 rows agree to a few 1e-6: a component that close
    to a rounding boundary rounds the other way, and one near zero keeps
    its f32 difference), the grid geometry equal.
  * ``same``, a port index over the f32 rows and regional rows the JAX build
    stored, behind the JAX whitening: stores byte-equal to the JAX Index's.
  * the oracle route (``with_search(use_pallas=False)``; the JAX Index on
    the CPU takes its oracle) on ``query_images``: only the query
    descriptors differ, by the two extractors' ~1e-6, so fused scores agree
    to NEAR_TIE = 2e-5, and ids are equal except where JAX's fused scores
    of the two ids are within NEAR_TIE of each other.
  * the kernel route (K1's plain version on a CPU store) against the
    reference's ``_search_composite_jit(use_pallas=True, do_rerank=True)``
    with the interpret-mode K1, on the same store and the same query rows:
    only summation orders differ, so scores within 1e-6, ids by the
    NEAR_TIE rule.
  * ``rerank_from_candidates`` and ``build_vote_matrix`` against JAX's on
    seeded inputs: scores within 1e-6, ids equal.
  * refine over int4 and an int8 regional store: stores byte-equal to the
    JAX Index's (the same ``quantize_rows``), searches as above.
  * ``evaluate_index``: the stages applied as listed, and mAP within 0.1
    points of JAX's, as in tests/parity/test_pipeline_oracle.py.
"""
import functools
import json
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import instsearch_tpu.index as jindex
import instsearch_tpu.kernels as jax_kernels
import instsearch_torch.index as tindex
from instsearch_tpu.config import (ExtractConfig, IndexConfig, PipelineConfig,
                                   SearchConfig)
from instsearch_tpu.data import native_frontend
from instsearch_tpu.eval import make_mini_dataset
from instsearch_tpu.eval.evaluate import evaluate_index as jax_evaluate
from instsearch_tpu.eval.evaluate import \
    extract_query_regional as jax_query_regional
from instsearch_tpu.index import Index as JaxIndex
from instsearch_tpu.index import _search_composite_jit
from instsearch_tpu.models.vgg import vgg16 as jax_vgg16
from instsearch_tpu.ops.pooling import rmac_region_geometry as jax_geometry
from instsearch_tpu.search.rerank import region_match_scores as jax_match
from instsearch_tpu.search.rerank import \
    rerank_from_candidates as jax_rerank
from instsearch_tpu.search.spatial import build_vote_matrix as jax_votes
from instsearch_torch import PipelineConfig as TorchPipelineConfig
from instsearch_torch.data import frontend
from instsearch_torch.eval.evaluate import (evaluate_index,
                                            extract_query_regional)
from instsearch_torch.extractor import Extractor
from instsearch_torch.index import Index, attach_regional_store
from instsearch_torch.ops.pooling import rmac_region_geometry
from instsearch_torch.ops.whitening import WhiteningParams
from instsearch_torch.parallel import make_mesh
from instsearch_torch.search.pq_view import PQView
from instsearch_torch.search.rerank import (region_match_scores,
                                            rerank_from_candidates)
from instsearch_torch.search.spatial import build_vote_matrix
from instsearch_torch.serve import ServeCore

SIZE = 96
NEAR_TIE = 2e-5
KERNEL_SCORE_TOL = 1e-6
ROWS_TOL = 1e-5
CFG = PipelineConfig(
    extract=ExtractConfig(backbone="vgg16", pooling="rmac", rmac_levels=3,
                          image_size=SIZE, whiten=True, whiten_dim=16,
                          dtype="float32", batch_size=8),
    index=IndexConfig(dtype="bfloat16"),
    search=SearchConfig(k=10, rerank_enabled=True, rerank_depth=100))
REFINE = CFG.replace(
    index=IndexConfig(dtype="int4", refine_dtype="int8"),
    search=CFG.search.replace(rerank_enabled=False, refine_enabled=True))


def _port_cfg(cfg: PipelineConfig):
    return TorchPipelineConfig.from_json(cfg.to_json())


@pytest.fixture(scope="module")
def rig(tmp_path_factory):
    """The JAX build over PNG copies of the mini fixture (recording the f32
    rows and regional rows it stored) and its evaluations; the port's own
    build with the JAX whitening; ``same``, a port index over the JAX
    build's stored rows."""
    root = tmp_path_factory.mktemp("rerank_slice")
    ds = make_mini_dataset(str(root), seed=9, size=SIZE)
    os.makedirs(root / "png")
    paths = []
    for p in ds.db_paths:
        png = str(root / "png" / (os.path.basename(p)[:-4] + ".png"))
        cv2.imwrite(png, cv2.imread(p))
        paths.append(png)
    variables = jax.tree_util.tree_map(np.asarray, jax_vgg16(
        jnp.float32).init(jax.random.PRNGKey(0),
                          np.zeros((1, SIZE, SIZE, 3), np.float32)))
    seen = {}
    build_from = JaxIndex.from_descriptors.__func__
    attach = jindex.attach_regional_store

    def rows(cls, descriptors, *a, **kw):
        seen["rows"] = np.array(descriptors, np.float32)
        seen["kept"] = kw.get("original_ids")
        return build_from(cls, descriptors, *a, **kw)

    def regional(idx, reg):
        seen["regional"] = np.array(reg, np.float32)
        return attach(idx, reg)

    spatial = CFG.search.replace(spatial_weight=0.5)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native_frontend, "available", lambda: False)
        mp.setattr(JaxIndex, "from_descriptors", classmethod(rows))
        mp.setattr(jindex, "attach_regional_store", regional)
        jidx = JaxIndex.build(paths, CFG, variables=variables)
        mp.undo()
        mp.setattr(native_frontend, "available", lambda: False)
        jrefine = JaxIndex.from_descriptors(
            seen["rows"], jidx.names, REFINE, extractor=jidx.extractor,
            original_ids=seen["kept"])
        jeval = {"rerank": jax_evaluate(jidx, ds),
                 "spatial": jax_evaluate(jidx, ds, search_cfg=spatial),
                 "refine": jax_evaluate(jrefine, ds)}
    tcfg = _port_cfg(CFG)
    jw = jidx.extractor.whitening
    white = WhiteningParams(torch.tensor(np.asarray(jw.P)),
                            torch.tensor(np.asarray(jw.mu)))
    own = Index.build(paths, tcfg, variables=variables, whitening=white,
                      device="cpu")
    ex = Extractor(tcfg.extract.replace(whiten=False), variables,
                   whitening=white, device="cpu")
    same = Index.from_descriptors(seen["rows"], jidx.names, tcfg,
                                  extractor=ex, original_ids=seen["kept"])
    attach_regional_store(same, seen["regional"])
    qimgs = np.stack([frontend.load_square(p, SIZE) for p in ds.query_paths])
    return dict(ds=ds, jidx=jidx, jrefine=jrefine, jeval=jeval, own=own,
                same=same, seen=seen, qimgs=qimgs, paths=paths,
                variables=variables)


def _assert_topk_agree(js, ji, ts, ti, score_tol):
    """Equal ids, except at slots where JAX itself scores the two ids within
    NEAR_TIE of each other; scores within score_tol."""
    js, ji = np.asarray(js), np.asarray(ji)
    assert ti.shape == ji.shape
    for q in range(ji.shape[0]):
        jscore = dict(zip(ji[q].tolist(), js[q].tolist()))
        for a, b in zip(ji[q], ti[q]):
            if a != b:
                assert b in jscore, (q, a, b)
                assert abs(jscore[a] - jscore[b]) < NEAR_TIE, (q, a, b)
    np.testing.assert_allclose(ts, js, rtol=0, atol=score_tol)


def _bf16_close(got: torch.Tensor, want) -> None:
    """Within one bf16 step of each other (a step is at most 2^-7 of the
    larger magnitude) plus ROWS_TOL, element by element."""
    g = got.float().numpy()
    w = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert g.shape == w.shape
    bar = 2 ** -7 * np.maximum(np.abs(g), np.abs(w)) + ROWS_TOL
    assert (np.abs(g - w) <= bar).all()


def test_stores_match_jax_build(rig):
    jidx, own, same = rig["jidx"], rig["own"], rig["same"]
    assert own.names == same.names == jidx.names
    n_pad = jidx.descriptors.shape[0]
    for idx in (own, same):
        assert idx.regional.dtype == torch.bfloat16
        assert tuple(idx.regional.shape) == (n_pad, 14, 16)
        assert idx.regional_scales is None
        np.testing.assert_array_equal(idx.regional_geom,
                                      np.asarray(jidx.regional_geom))
        np.testing.assert_array_equal(idx.ids.numpy(), np.asarray(jidx.ids))
    np.testing.assert_array_equal(own.regional_geom, jax_geometry(6, 6, 3))
    _bf16_close(own.regional, jidx.regional)
    _bf16_close(own.descriptors, jidx.descriptors)
    np.testing.assert_array_equal(
        same.regional.float().numpy(),
        np.asarray(jidx.regional.astype(jnp.float32)))
    assert not same.regional[same.num_valid:].any()
    # the regional rows are unit-norm per region after whitening
    norms = np.linalg.norm(rig["seen"]["regional"], axis=-1)
    np.testing.assert_allclose(norms, 1.0, atol=1e-5)


def test_regional_queries_match_jax(rig):
    """One combined pass gives the global descriptor and the regional rows;
    each within 1e-5 of JAX's own two passes."""
    jex, tex = rig["jidx"].extractor, rig["same"].extractor
    q = rig["qimgs"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native_frontend, "available", lambda: False)
        jd = np.asarray(jex(q))
        jr = np.asarray(jex.extract_regional(q))
    td, tr = tex.extract_with_regional(q)
    np.testing.assert_allclose(td.numpy(), jd, rtol=0, atol=1e-5)
    np.testing.assert_allclose(tr.numpy(), jr, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(td.numpy(), tex(q).numpy())
    np.testing.assert_array_equal(tr.numpy(), tex.extract_regional(q).numpy())


def test_query_regional_of_a_dataset_matches_jax(rig):
    """The protocol's bbox-cropped regional query rows, as the evaluation
    extracts them, within 1e-5 of JAX's."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native_frontend, "available", lambda: False)
        want = jax_query_regional(rig["jidx"], rig["ds"])
    got = extract_query_regional(rig["same"], rig["ds"])
    assert got.shape == want.shape == (len(rig["ds"].qimlist), 14, 16)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("spatial_weight", [0.0, 0.5])
def test_oracle_route_matches_jax_index(rig, spatial_weight):
    jidx, same, qimgs = rig["jidx"], rig["same"], rig["qimgs"]
    scfg = CFG.search.replace(spatial_weight=spatial_weight)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native_frontend, "available", lambda: False)
        js, ji = jidx.query_images(qimgs, scfg)
    ts, ti = same.with_search(use_pallas=False).query_images(
        qimgs, _port_cfg(CFG).search.replace(spatial_weight=spatial_weight))
    _assert_topk_agree(js, ji, ts, ti, NEAR_TIE)
    assert (ti[:, 0] >= 0).all()


@pytest.mark.parametrize("spatial_weight", [0.0, 0.5])
def test_kernel_route_matches_jax_composite(rig, spatial_weight,
                                            monkeypatch):
    jidx, same, qimgs = rig["jidx"], rig["same"], rig["qimgs"]
    launched = []
    interp = functools.partial(jax_kernels.topk_matmul, interpret=True)
    monkeypatch.setattr(jax_kernels, "topk_matmul",
                        lambda *a, **kw: launched.append(1) or interp(*a,
                                                                      **kw))
    q, qreg = same.extractor.extract_with_regional(qimgs)
    q, qreg = q.numpy(), qreg.numpy()
    js, ji = _search_composite_jit(
        jidx.descriptors, jidx.ids, jidx._match_query_dim(jnp.asarray(q)),
        jnp.asarray(jidx.num_valid, jnp.int32), jidx.scales, jidx.regional,
        None, jnp.asarray(qreg),
        jidx.vote_matrix if spatial_weight else None, k=10, depth=100,
        qe_n=10, qe_alpha=3.0, use_pallas=True, do_qe=False, do_rerank=True,
        spatial_weight=spatial_weight)
    assert launched, "the JAX composite did not reach its kernel"
    calls = []
    monkeypatch.setattr(tindex, "topk_matmul", functools.partial(
        lambda f, *a, **kw: calls.append(kw["k"]) or f(*a, **kw),
        tindex.topk_matmul))
    scfg = _port_cfg(CFG).search.replace(spatial_weight=spatial_weight)
    ts, ti = same.search(q, scfg, query_regional=qreg)
    assert calls == [100]                     # one K1 call, the top-100
    _assert_topk_agree(js, ji, ts, ti, KERNEL_SCORE_TOL)


def _candidates(seed, q=5, depth=12, n=40, r=4, d=16, store="float32"):
    """Seeded inputs of rerank_from_candidates: a unit regional store with
    padding rows (id -1), candidate scores sorted descending with -inf
    empty slots at the end and their positions (-1 there)."""
    rng = np.random.default_rng(seed)
    reg = rng.standard_normal((n, r, d)).astype(np.float32)
    reg /= np.linalg.norm(reg, axis=-1, keepdims=True)
    ids = np.where(np.arange(n) < n - 8, np.arange(n) + 100, -1).astype(
        np.int32)
    pos = np.stack([rng.choice(n - 8, depth, replace=False)
                    for _ in range(q)]).astype(np.int32)
    g = -np.sort(-rng.uniform(0.2, 0.9, (q, depth)), axis=1).astype(
        np.float32)
    g[1, depth // 2:] = -np.inf                   # a query with empty slots
    pos[1, depth // 2:] = -1
    qreg = rng.standard_normal((q, r, d)).astype(np.float32)
    qreg /= np.linalg.norm(qreg, axis=-1, keepdims=True)
    scales = None
    if store == "int8":
        scales = (np.abs(reg).max(-1) / 127).astype(np.float32)
        reg = np.round(reg / scales[..., None]).astype(np.int8)
    return reg, scales, ids, g, pos, qreg


def _rerank_both(reg, scales, ids, g, pos, qreg, **kw):
    js, ji = jax_rerank(jnp.asarray(reg), jnp.asarray(ids), jnp.asarray(g),
                        jnp.asarray(pos), jnp.asarray(qreg),
                        regional_scales=None if scales is None
                        else jnp.asarray(scales), **kw)
    kw = dict(kw)
    if kw.get("vote_matrix") is not None:
        kw["vote_matrix"] = torch.from_numpy(kw["vote_matrix"])
    ts, ti = rerank_from_candidates(
        torch.from_numpy(reg), torch.from_numpy(ids), torch.from_numpy(g),
        torch.from_numpy(pos), torch.from_numpy(qreg),
        regional_scales=None if scales is None else torch.from_numpy(scales),
        **kw)
    return np.asarray(js), np.asarray(ji), ts.numpy(), ti.numpy()


@pytest.mark.parametrize("case", ["plain", "k_past_depth", "int8_scales",
                                  "refine_empty_slot", "ties", "spatial"])
def test_rerank_from_candidates_matches_jax(case):
    store = "int8" if case == "int8_scales" else "float32"
    reg, scales, ids, g, pos, qreg = _candidates(7, store=store)
    kw = {"k": 5}
    if case == "k_past_depth":
        kw["k"] = 20
    if case == "refine_empty_slot":
        # the refine route: one region, no global term; an empty slot
        # computes match + 0 * -inf = NaN before the isfinite repair
        reg, qreg = reg[:, :1], qreg[:, :1]
        kw.update(k=12, fuse_weight=0.0)
    if case == "ties":
        # copies of one row at several candidate slots with equal global
        # scores: the lower slot first, as lax.top_k
        reg[:] = reg[0]
        g[:] = 0.5
        g[1, 6:] = -np.inf
    if case == "spatial":
        geom = rmac_region_geometry(3, 5, 2)
        reg = np.repeat(reg, 2, axis=1)[:, :len(geom)]
        qreg = np.repeat(qreg, 2, axis=1)[:, :len(geom)]
        kw.update(spatial_weight=0.5, vote_matrix=build_vote_matrix(geom,
                                                                    geom))
    js, ji, ts, ti = _rerank_both(reg, scales, ids, g, pos, qreg, **kw)
    assert ts.shape == (5, kw["k"]) and ti.dtype == np.int32
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(ts, js, rtol=0, atol=1e-6)
    assert not np.isnan(ts).any()
    # padding rows (id -1) are never candidates, so never come out; empty
    # slots come out as (-inf, -1) and only after every filled one
    assert ((ti >= 0) == np.isfinite(ts)).all()
    assert np.isin(ti[ti >= 0], ids[ids >= 0]).all()
    assert (ti[1, 6:] == -1).all()
    if case == "k_past_depth":
        assert (ti[:, 12:] == -1).all() and np.isneginf(ts[:, 12:]).all()
    if case == "ties":
        want = np.take_along_axis(pos, np.argsort(-g, axis=1, kind="stable"),
                                  1)[:, :5]
        np.testing.assert_array_equal(ti, np.where(want >= 0,
                                                   ids[want], -1))


@pytest.mark.parametrize("store", ["float32", "int8"])
def test_region_match_scores_match_jax(store):
    reg, scales, _, _, pos, qreg = _candidates(11, store=store)
    want = jax_match(jnp.asarray(reg), jnp.asarray(pos), jnp.asarray(qreg),
                     None if scales is None else jnp.asarray(scales))
    got = region_match_scores(
        torch.from_numpy(reg), torch.from_numpy(pos), torch.from_numpy(qreg),
        None if scales is None else torch.from_numpy(scales))
    assert tuple(got.shape) == pos.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("h,w", [(32, 32), (6, 6), (32, 24)])
def test_vote_matrix_equals_jax(h, w):
    geom = rmac_region_geometry(h, w, 3)
    got = build_vote_matrix(geom, geom)
    want = jax_votes(jax_geometry(h, w, 3), jax_geometry(h, w, 3))
    np.testing.assert_array_equal(got, want)
    assert got.shape == (len(geom) ** 2, 75)
    np.testing.assert_array_equal(got.sum(1), 1.0)


def _unit_rows(n, d, seed):
    x = np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.mark.parametrize("d", [40, 39])
def test_refine_over_int4_matches_jax(d, monkeypatch):
    """from_descriptors(refine_dtype="int8") over an int4 store: the
    one-region int8 copy of the original rows is byte-equal to JAX's (an odd
    width counts its zero column, as there); the refined search on the
    oracle route against the JAX Index, on the kernel route (K3's plain
    version) against the interpret-mode composite."""
    x = _unit_rows(300, d, seed=d)
    q = x[::37] + 0.05 * _unit_rows(9, d, seed=1)
    names = [f"r{i}" for i in range(300)]
    cfg = REFINE.replace(index=REFINE.index.replace(row_tile=64))
    jidx = JaxIndex.from_descriptors(x, names, cfg)
    tidx = Index.from_descriptors(x, names, _port_cfg(cfg), device="cpu")
    assert tidx.has_refine_store and jidx.has_refine_store
    assert tidx.regional.dtype == torch.int8
    assert tidx.regional_geom is None
    np.testing.assert_array_equal(tidx.regional.numpy(),
                                  np.asarray(jidx.regional))
    np.testing.assert_array_equal(
        tidx.regional_scales.numpy().view(np.uint32),
        np.asarray(jidx.regional_scales).view(np.uint32))
    js, ji = jidx.search(q)
    ts, ti = tidx.with_search(use_pallas=False).search(q)
    _assert_topk_agree(js, ji, ts, ti, 1e-6)
    if d % 2:
        # the reference's int4 kernel takes no odd width (its tile rule
        # sends it to the oracle, which scores an unquantized query), so the
        # kernel route is compared at the even width
        return
    interp = functools.partial(jax_kernels.topk_matmul_int4, interpret=True)
    launched = []
    monkeypatch.setattr(jax_kernels, "topk_matmul_int4",
                        lambda *a, **kw: launched.append(1) or interp(*a,
                                                                      **kw))
    qq = jidx._match_query_dim(jnp.asarray(q))
    ks, ki = _search_composite_jit(
        jidx.descriptors, jidx.ids, qq, jnp.asarray(300, jnp.int32),
        jidx.scales, jidx.regional, jidx.regional_scales, None, k=10,
        depth=100, qe_n=10, qe_alpha=3.0, use_pallas=True, do_qe=False,
        do_rerank=False, int4=True, do_refine=True, fuse_weight=0.0)
    assert launched
    ps, pi = tidx.search(q)
    _assert_topk_agree(ks, ki, ps, pi, 1e-6)
    # the refined scores are the int8 copy's cosines: the query's own row
    # (queries 0, 37, ...) stays its top-1
    np.testing.assert_array_equal(pi[:, 0], np.arange(0, 300, 37))


def test_int8_regional_store_matches_jax(rig):
    """An int8 index quantizes the regional store per (row, region) over the
    flattened padded rows: byte-equal to JAX's; the re-ranked search on the
    oracle route agrees."""
    seen, jidx, qimgs = rig["seen"], rig["jidx"], rig["qimgs"]
    cfg = CFG.replace(index=IndexConfig(dtype="int8"))
    j8 = JaxIndex.from_descriptors(seen["rows"], jidx.names, cfg,
                                   extractor=jidx.extractor,
                                   original_ids=seen["kept"])
    jindex.attach_regional_store(j8, seen["regional"])
    t8 = Index.from_descriptors(seen["rows"], jidx.names, _port_cfg(cfg),
                                extractor=rig["same"].extractor,
                                original_ids=seen["kept"])
    attach_regional_store(t8, torch.from_numpy(seen["regional"]), chunk=7)
    np.testing.assert_array_equal(t8.regional.numpy(), np.asarray(j8.regional))
    np.testing.assert_array_equal(
        t8.regional_scales.numpy().view(np.uint32),
        np.asarray(j8.regional_scales).view(np.uint32))
    q, qreg = t8.extractor.extract_with_regional(qimgs)
    js, ji = j8.search(q.numpy(), query_regional=qreg.numpy())
    ts, ti = t8.with_search(use_pallas=False).search(q, query_regional=qreg)
    _assert_topk_agree(js, ji, ts, ti, 1e-6)


@pytest.mark.parametrize("stage", ["rerank", "spatial", "refine"])
def test_evaluate_applies_stages_like_jax(rig, stage):
    jeval = rig["jeval"][stage]
    if stage == "refine":
        same = rig["same"]
        idx = Index.from_descriptors(
            rig["seen"]["rows"], same.names, _port_cfg(REFINE),
            extractor=same.extractor, original_ids=rig["seen"]["kept"])
        res = evaluate_index(idx, rig["ds"])
    else:
        scfg = _port_cfg(CFG).search.replace(
            spatial_weight=0.5 if stage == "spatial" else 0.0)
        res = evaluate_index(rig["same"], rig["ds"], search_cfg=scfg)
    assert res["stages_applied"] == jeval["stages_applied"] == {
        "rerank": ["rerank"], "spatial": ["rerank", "spatial"],
        "refine": ["refine"]}[stage]
    assert res["mAP"] == pytest.approx(jeval["mAP"], abs=0.1), (
        res["mAP"], jeval["mAP"])


def test_rescoring_cfg_errors(rig):
    same, q = rig["same"], rig["qimgs"][:1]
    scfg = _port_cfg(CFG).search
    d = same.extractor(q)
    for bad, match in (
            (scfg.replace(refine_enabled=True), "mutually exclusive"),
            (scfg.replace(rerank_enabled=False, refine_enabled=True),
             "re-rank store"),
            (scfg.replace(rerank_enabled=False, spatial_weight=0.5),
             "fuses into the regional re-rank")):
        with pytest.raises(ValueError, match=match):
            same.search(d, bad)
        with pytest.raises(ValueError, match=match):
            same.query_images(q, bad)
        with pytest.raises(ValueError, match=match):
            evaluate_index(same, rig["ds"], search_cfg=bad)
    # a store attached without a matching extractor has no geometry
    bare = Index.from_descriptors(rig["seen"]["rows"], same.names,
                                  _port_cfg(CFG), device="cpu")
    attach_regional_store(bare, rig["seen"]["regional"])
    assert bare.regional_geom is None and bare.vote_matrix is None
    with pytest.raises(ValueError, match="grid geometry"):
        bare.search(d, scfg.replace(spatial_weight=0.5))
    # the refine store is not a re-rank store, and refine needs int4
    refine_cfg = _port_cfg(REFINE)
    ridx = Index.from_descriptors(rig["seen"]["rows"], same.names,
                                  refine_cfg, device="cpu")
    with pytest.raises(ValueError, match="exact-refine row copy"):
        ridx.search(d, refine_cfg.search.replace(refine_enabled=False,
                                                 rerank_enabled=True))
    for icfg in (IndexConfig(dtype="bfloat16", refine_dtype="int8"),
                 IndexConfig(dtype="int4", refine_dtype="int4")):
        with pytest.raises(ValueError, match="refine_dtype"):
            Index.from_descriptors(rig["seen"]["rows"], same.names,
                                   refine_cfg.replace(index=icfg),
                                   device="cpu")
    with pytest.raises(ValueError, match="both claim"):
        Index.from_descriptors(
            rig["seen"]["rows"], same.names,
            refine_cfg.replace(search=scfg), device="cpu")
    with pytest.raises(ValueError, match="query_regional"):
        same.search(d, query_regional=np.zeros((1, 14, 8), np.float32))
    with pytest.raises(ValueError, match="regional rows"):
        attach_regional_store(bare, rig["seen"]["regional"][:3])


@pytest.mark.parametrize("preset", ["paris6k_vgg16_rmac_whiten",
                                    "rerank_regional_top100",
                                    "spatial_rerank_top100"])
def test_presets_build_and_query(rig, preset):
    """The workload presets as loaded, cut to this fixture's size (96 px,
    16 whitened dims, the fixture's first 24 images; the spatial preset
    keeps its 2 shards): ``Index.build`` and ``query_images`` answer, every
    query's own PNG image its top-1, on one device and through
    ``to_sharded`` alike."""
    cfg = TorchPipelineConfig.load(os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "configs", preset + ".json"))
    assert cfg.extract.backbone == "vgg16" and cfg.extract.pooling == "rmac"
    cfg = cfg.replace(
        extract=cfg.extract.replace(image_size=SIZE, whiten_dim=16,
                                    dtype="float32"))
    paths = rig["paths"][:24]
    idx = Index.build(paths, cfg, variables=rig["variables"], device="cpu")
    assert (idx.regional is not None) == cfg.search.rerank_enabled
    imgs = np.stack([frontend.load_square(p, SIZE) for p in paths[::5]])
    s, i = idx.query_images(imgs)
    np.testing.assert_array_equal(i[:, 0], np.arange(0, 24, 5))
    assert np.isfinite(s).all()
    shards = cfg.index.num_shards
    sidx = idx.to_sharded(mesh=make_mesh(shards, devices=["cpu"] * shards))
    ss, si = idx.query_images(imgs, sharded_index=sidx)
    np.testing.assert_array_equal(si, i)
    np.testing.assert_array_equal(ss, s)


def test_unported_neighbours_raise(rig, tmp_path):
    """Re-rank under the PQ cascade (ported since ROADMAP M9) answers, over
    the JAX view's codes as JAX's does (the oracle route on both sides);
    diffusion (M8) answers. The live index keeps the regional store: a
    descriptor ``add`` is refused (the regional rows need image paths, as
    in the reference), unknown names and a self-merge are refused, and a
    saved and loaded copy carries the store and its grid geometry into
    ``remove``. An index of two shards builds (the sharded index is
    ported)."""
    same, q = rig["same"], rig["qimgs"][:2]
    jidx = rig["jidx"]
    jtwin = JaxIndex(jidx.descriptors, jidx.ids, jidx.names, jidx.cfg,
                     regional=jidx.regional)
    jpq = jtwin.build_pq(m=4, iters=2, depth=20)
    twin = same.with_search(use_pallas=False)
    twin.pq = PQView.from_arrays(np.asarray(jpq.codebook.centroids),
                                 np.asarray(jpq.codes), depth=20,
                                 device="cpu")
    twin.cfg = twin.cfg.replace(search=twin.cfg.search.replace(pq_depth=20))
    jq = np.asarray(jidx.extractor(q))
    jreg = np.asarray(jidx.extractor.extract_regional(q))
    js, ji = jtwin.search(jq, query_regional=jreg)
    ts, ti = twin.search(jq, query_regional=jreg)
    _assert_topk_agree(np.asarray(js), np.asarray(ji), ts, ti, 1e-5)
    # without re-rank the cascade serves; refine would bypass it
    s, i = twin.query_images(q, twin.cfg.search.replace(rerank_enabled=False))
    assert i.shape == (2, 10)
    with pytest.raises(ValueError, match="needs image paths"):
        same.add(descriptors=rig["seen"]["rows"][:1], names=["x"])
    with pytest.raises(KeyError, match="not in index"):
        same.remove(["x"])
    with pytest.raises(ValueError, match="into itself"):
        same.merge_from(same)
    same.save(str(tmp_path))
    copy = Index.load(str(tmp_path), device="cpu")
    assert torch.equal(copy.regional, same.regional)
    np.testing.assert_array_equal(copy.regional_geom, same.regional_geom)
    gone = copy.names[0]
    assert copy.remove([gone]) == 1 and gone not in copy.names
    assert torch.equal(copy.regional[0], same.regional[copy.num_valid])
    two = Index.from_descriptors(
        rig["seen"]["rows"], same.names,
        _port_cfg(CFG).replace(index=IndexConfig(num_shards=2)),
        device="cpu")
    assert two.descriptors.shape[0] % 16 == 0
    # diffusion answers (M8 is ported), the R-MAC store beside it unused
    dcfg = same.cfg.search.replace(rerank_enabled=False,
                                   diffusion_enabled=True)
    s, i = same.search(same.extractor(q), dcfg)
    assert i.shape == (2, 10) and np.isfinite(s).all()
    np.testing.assert_array_equal(
        i, same.search(same.extractor(q), dcfg, query_regional=np.zeros(
            (2, same.regional.shape[1], same.dim), np.float32))[1])


def test_serve_core_answers_like_query_images(rig):
    """The re-rank preset serves through ServeCore's buckets (1, 2, 4, 8):
    3 images run as one 4-bucket piece, 9 as an 8-piece and a 1-piece."""
    own, ds, qimgs = rig["own"], rig["ds"], rig["qimgs"]
    core = ServeCore(own)
    core.warmup()
    _, want = own.query_images(qimgs[:3])
    three = core.handle_line(json.dumps({"images": ds.query_paths[:3]}))
    for row, ids in zip(three["results"], want):
        assert [r["id"] for r in row] == ids.tolist()
        assert all(r["name"] == own.name_of(r["id"]) for r in row)
    paths = [ds.query_paths[i % len(ds.query_paths)] for i in range(9)]
    nine = core.handle_line(json.dumps({"images": paths, "k": 3}))
    assert nine["batch_rows"] == 9 and len(nine["results"]) == 9
    assert [row[0]["id"] for row in nine["results"][:3]] == want[:, 0].tolist()
