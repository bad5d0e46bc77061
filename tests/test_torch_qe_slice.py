"""The quantized-store serving path end to end against the JAX Index on the
mini fixture: images -> ResNet-18 (the same variables on both sides) -> GeM
-> PCA whitening -> int8 or int4 store (55 whitened components; int4 pads
them to 56, 28 bytes per row) -> alpha query expansion -> top-k -> mAP, and
the serving core on top.

Both sides decode with cv2 (the JAX frontend's native decoder is switched
off, as in test_torch_slice.py). Extraction runs in f32.

What is compared, and the tolerances:
  * the store. Quantizing the f32 rows that ``JaxIndex.build`` quantized
    gives a port store, scales and ids byte-equal to the JAX Index's: no
    tolerance.
  * the oracle route (the port index's own config has use_pallas off)
    against the JAX Index on the CPU, which takes its oracle there. The
    store is the byte-equal one; only the query descriptors differ, by the
    two extractors' ~1e-5 (see test_torch_slice.py). QE and the final
    ranking score f32 queries against the same integers, so the gap stays
    of that order: measured 3.1e-6 (int8) and 3.3e-6 (int4) on scores, ids
    all equal. Ids must be equal except where JAX scores the two ids within
    NEAR_TIE = 2e-5 of each other, and scores agree to 2e-5.
  * the kernel route (use_pallas on: K2/K3's plain versions on a CPU
    store) against the reference's composite ``_search_composite_jit(...,
    use_pallas=True, do_qe=True)`` with the Pallas kernels in interpret
    mode, on the same store and the same query descriptors. The only
    difference is the order of the f32 sums inside the expansion (a few
    ulp); the expanded query is then quantized to int8 by both, so a
    component lying on a rounding boundary could flip one step. Measured:
    ids equal, scores within 1.2e-7 (one ulp at the top scores); the test
    allows 1e-6 on scores and the NEAR_TIE rule on ids.
  * mAP of the port's own build (its own extraction and whitening) within
    0.1 points of JAX's, as in tests/parity/test_pipeline_oracle.py.
"""
import functools
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import instsearch_tpu.kernels as jax_kernels
import instsearch_torch.index as tindex
from instsearch_tpu.config import (ExtractConfig, IndexConfig, PipelineConfig,
                                   SearchConfig)
from instsearch_tpu.data import native_frontend
from instsearch_tpu.eval import make_mini_dataset
from instsearch_tpu.index import Index as JaxIndex
from instsearch_tpu.index import _search_composite_jit
from instsearch_tpu.models import load_torch_resnet
from instsearch_tpu.ops.quantize import unpack_int4 as jax_unpack_int4
from instsearch_torch import PipelineConfig as TorchPipelineConfig
from instsearch_torch.data import frontend
from instsearch_torch.extractor import Extractor
from instsearch_torch.index import Index
from instsearch_torch.ops.quantize import unpack_int4
from instsearch_torch.ops.whitening import WhiteningParams
from instsearch_torch.serve import ServeCore

from parity.torch_models import BasicBlock, TruncatedResNet, randomize_bn_stats

SIZE = 64
NEAR_TIE = 2e-5
KERNEL_SCORE_TOL = 1e-6


def _cfg(kind: str) -> PipelineConfig:
    return PipelineConfig(
        extract=ExtractConfig(backbone="resnet18", pooling="gem",
                              image_size=SIZE, whiten=True, dtype="float32",
                              batch_size=16),
        index=IndexConfig(dtype=kind),
        search=SearchConfig(k=10, qe_enabled=True, qe_n=5, qe_alpha=3.0))


def _port_cfg(cfg: PipelineConfig):
    return TorchPipelineConfig.from_json(cfg.to_json())


@pytest.fixture(scope="module")
def fixture_data(tmp_path_factory):
    ds = make_mini_dataset(str(tmp_path_factory.mktemp("qe_slice")), seed=9,
                           size=SIZE)
    torch.manual_seed(0)
    tm = randomize_bn_stats(TruncatedResNet(layers=(2, 2, 2, 2),
                                            block=BasicBlock))
    variables = load_torch_resnet(tm.state_dict())
    qimgs = np.stack([frontend.load_square(p, SIZE) for p in ds.query_paths])
    return ds, variables, qimgs


@pytest.fixture(scope="module", params=["int8", "int4"])
def rig(request, fixture_data):
    """JAX Index.build and its evaluation; the port's own Index.build; and
    ``same``, a port index over the f32 rows the JAX build quantized, whose
    extractor whitens with the JAX build's fit (each side's PCA may flip
    the sign of an eigenvector, so a query must be whitened by the fit its
    store was)."""
    ds, variables, qimgs = fixture_data
    kind = request.param
    cfg = _cfg(kind)
    seen = []
    build_from = JaxIndex.from_descriptors.__func__

    def recording(cls, descriptors, *a, **kw):
        seen.append((np.array(descriptors, np.float32), kw.get(
            "original_ids")))
        return build_from(cls, descriptors, *a, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native_frontend, "available", lambda: False)
        mp.setattr(JaxIndex, "from_descriptors", classmethod(recording))
        jidx = JaxIndex.build(ds.db_paths, cfg, variables=variables)
        jmap = jidx.evaluate(ds)["mAP"]
    rows, kept = seen[0]
    tcfg = _port_cfg(cfg)
    own = Index.build(ds.db_paths, tcfg, variables=variables, device="cpu")
    jw = jidx.extractor.whitening
    ex = Extractor(tcfg.extract.replace(whiten=False), variables,
                   whitening=WhiteningParams(torch.tensor(np.asarray(jw.P)),
                                             torch.tensor(np.asarray(jw.mu))),
                   device="cpu")
    same = Index.from_descriptors(rows, jidx.names, tcfg, extractor=ex,
                                  original_ids=kept)
    return kind, ds, qimgs, jidx, jmap, own, same


def _assert_topk_agree(js, ji, ts, ti, score_tol):
    """Equal ids, except at slots where JAX itself scores the two ids within
    NEAR_TIE of each other; scores within score_tol."""
    for q in range(ji.shape[0]):
        jscore = dict(zip(ji[q].tolist(), js[q].tolist()))
        for a, b in zip(ji[q], ti[q]):
            if a != b:
                assert b in jscore, (q, a, b)
                assert abs(jscore[a] - jscore[b]) < NEAR_TIE, (q, a, b)
    np.testing.assert_allclose(ts, js, rtol=0, atol=score_tol)


def test_store_byte_equal_to_jax_build(rig):
    kind, ds, _, jidx, _, own, same = rig
    # the port's rows carry zero columns past the reference's width, up to
    # the width its kernels read; they change no row scale. int4 packs the
    # two halves of a row into one byte, so its stored components (one int8
    # each, unpacked) are compared
    rows = jidx.descriptors.shape[0]
    for idx in (same, own):
        assert idx.descriptors.dtype == torch.int8
        assert idx.descriptors.shape[0] == rows
        assert idx.store_dim >= idx.dim == jidx.dim
        assert idx.is_int4 == (kind == "int4")
        assert idx.names == jidx.names
        np.testing.assert_array_equal(idx.ids.numpy(), np.asarray(jidx.ids))
    got, want = same.descriptors, jnp.asarray(jidx.descriptors)
    if kind == "int4":
        got, want = unpack_int4(got), jax_unpack_int4(want)
    np.testing.assert_array_equal(got[:, :jidx.dim].numpy(), np.asarray(want))
    assert not got[:, jidx.dim:].any()
    np.testing.assert_array_equal(same.scales.numpy().view(np.uint32),
                                  np.asarray(jidx.scales).view(np.uint32))


def test_oracle_route_matches_jax_index(rig):
    _, _, qimgs, jidx, _, _, same = rig
    js, ji = jidx.query_images(qimgs)                  # the oracle on a CPU
    ts, ti = same.with_search(use_pallas=False).query_images(qimgs)
    _assert_topk_agree(np.asarray(js), np.asarray(ji), ts, ti, NEAR_TIE)


def test_kernel_route_matches_jax_composite(rig, monkeypatch):
    kind, _, qimgs, jidx, _, _, same = rig
    for name in ("topk_matmul_int8", "topk_matmul_int4"):
        monkeypatch.setattr(jax_kernels, name, functools.partial(
            getattr(jax_kernels, name), interpret=True))
    q = same.extractor(qimgs).numpy()
    scfg = jidx.cfg.search
    js, ji = _search_composite_jit(
        jidx.descriptors, jidx.ids, jidx._match_query_dim(jnp.asarray(q)),
        jnp.asarray(jidx.num_valid, jnp.int32), jidx.scales, None, None,
        None, k=scfg.k, depth=0, qe_n=scfg.qe_n, qe_alpha=scfg.qe_alpha,
        use_pallas=True, do_qe=True, do_rerank=False, int4=kind == "int4")
    ts, ti = same.search(q)
    _assert_topk_agree(np.asarray(js), np.asarray(ji), ts, ti,
                       KERNEL_SCORE_TOL)


def test_routes_reach_their_entries(rig, monkeypatch):
    """The kernel entry of the store's kind runs twice per QE search (top-
    qe_n, then the final top-k) when the index's own config has use_pallas
    on; the oracle twin calls search_topk twice and never a kernel."""
    kind, _, qimgs, _, _, _, same = rig
    calls = []
    for name in ("topk_matmul", "topk_matmul_int8", "topk_matmul_int4",
                 "search_topk"):
        fn = getattr(tindex, name)
        monkeypatch.setattr(tindex, name, functools.partial(
            lambda f, nm, *a, **kw: calls.append(nm) or f(*a, **kw), fn,
            name))
    q = same.extractor(qimgs[:3])
    same.search(q)
    assert calls == [f"topk_matmul_{kind}"] * 2
    calls.clear()
    same.with_search(use_pallas=False).search(q)
    assert calls == ["search_topk"] * 2
    calls.clear()
    same.search(q, same.cfg.search.replace(qe_enabled=False))
    assert calls == [f"topk_matmul_{kind}"]


def test_evaluate_map_matches_jax(rig):
    _, ds, _, _, jmap, own, _ = rig
    res = own.evaluate(ds)
    assert res["stages_applied"] == ["qe"]
    assert res["num_queries"] == len(ds.qimlist)
    assert res["mAP"] == pytest.approx(jmap, abs=0.1), (res["mAP"], jmap)


def test_serve_core_answers_like_query_images(rig):
    _, ds, qimgs, _, _, own, _ = rig
    core = ServeCore(own)
    core.warmup()
    assert core.ready_info() == {"ready": True, "rows": own.num_valid,
                                 "dim": own.dim}
    _, want = own.query_images(qimgs[:3])
    three = core.handle_line(json.dumps({"images": ds.query_paths[:3]}))
    for row, ids in zip(three["results"], want):
        assert [r["id"] for r in row] == ids.tolist()
        assert all(r["name"] == own.name_of(r["id"]) for r in row)
