"""``Index.save``/``Index.load`` and ``PQView.save``/``load`` in the
reference's npz form, across the two packages: a port save loaded by the
JAX package, a JAX save (``streaming=False``) loaded by the port.

The stores: 120 rows in a capacity of 128 (row tile 8; the reference's
padding rows, id -1, ride along) at D = 31, 39 and 40, in bf16, f32, int8
and int4 (the port writes ``dim`` columns, int4 paired over ``dim`` as the
reference pairs them, and pads back to the kernels' widths on load). Then a
regional store (bf16 and int8), the exact-refine store, a PQ view (codes
written unpadded, padded to words on load), whitening, the port's backbone
weights, and the refusals. After each load the stores must be byte-equal up
to ``dim`` (int4 by unpacked components), with ids, names, scales and the
config equal, and the answers of the loaded index equal to the saved one's
(the same bytes: ids and scores equal).
"""
import json
import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instsearch_tpu import IndexConfig as JaxIndexConfig
from instsearch_tpu import PipelineConfig as JaxPipelineConfig
from instsearch_tpu import SearchConfig as JaxSearchConfig
from instsearch_tpu.index import Index as JaxIndex
from instsearch_tpu.index import attach_regional_store as jax_attach
from instsearch_tpu.ops.quantize import unpack_int4 as jax_unpack_int4
from instsearch_tpu.ops.whitening import WhiteningParams as JaxWhitening
from instsearch_torch import (ExtractConfig, IndexConfig, PipelineConfig,
                              SearchConfig)
from instsearch_torch.extractor import Extractor
from instsearch_torch.index import Index, attach_regional_store
from instsearch_torch.kernels.fused_resnet import randomize_bn
from instsearch_torch.ops.quantize import unpack_int4
from instsearch_torch.ops.whitening import WhiteningParams

N, CAPACITY = 120, 128
DTYPES = ("bfloat16", "float32", "int8", "int4")


def _rows(d: int, n: int = N, seed: int = 0):
    rng = np.random.default_rng(seed + d)
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _cfgs(dtype: str, **index):
    icfg = dict(dtype=dtype, row_tile=8, capacity=CAPACITY, **index)
    return (JaxPipelineConfig(index=JaxIndexConfig(**icfg),
                              search=JaxSearchConfig(k=7)),
            PipelineConfig(index=IndexConfig(**icfg),
                           search=SearchConfig(k=7)))


def _components(idx, jax_side: bool) -> np.ndarray:
    x = idx.descriptors
    if jax_side:
        return np.asarray(jax_unpack_int4(x) if idx.is_int4 else
                          x.astype(jnp.float32) if x.dtype == jnp.bfloat16
                          else x)
    x = unpack_int4(x) if idx.is_int4 else x
    assert not x[:, idx.dim:].any()
    return x[:, :idx.dim].float().numpy()


def _assert_same(jidx, tidx):
    assert tidx.dim == jidx.dim
    np.testing.assert_array_equal(_components(tidx, False),
                                  _components(jidx, True).astype(np.float32))
    np.testing.assert_array_equal(tidx.ids.numpy(), np.asarray(jidx.ids))
    assert tidx.names == list(jidx.names)
    assert json.loads(tidx.cfg.to_json()) == json.loads(jidx.cfg.to_json())
    for mine, ref in ((tidx.scales, jidx.scales),
                      (tidx.regional, jidx.regional),
                      (tidx.regional_scales, jidx.regional_scales)):
        assert (mine is None) == (ref is None)
        if mine is not None:
            np.testing.assert_array_equal(mine.float().numpy(),
                                          np.asarray(ref, np.float32))
    assert (tidx.regional_geom is None) == (jidx.regional_geom is None)


def _assert_same_answers(a, b, q):
    for x, y in zip(a.with_search(use_pallas=False).search(q),
                    b.with_search(use_pallas=False).search(q)):
        np.testing.assert_array_equal(x, y)


def _port_twin(jidx, tcfg, x):
    """The port's index over the same rows, as the JAX one was built."""
    return Index.from_descriptors(x, list(jidx.names), tcfg, device="cpu")


@pytest.mark.parametrize("d", [31, 39, 40])
@pytest.mark.parametrize("dtype", DTYPES)
def test_port_save_loads_in_jax(dtype, d, tmp_path):
    jcfg, tcfg = _cfgs(dtype)
    x = _rows(d)
    tidx = Index.from_descriptors(x, [f"im{i}" for i in range(N)], tcfg,
                                  device="cpu")
    tidx.save(str(tmp_path))
    meta = json.load(open(tmp_path / "meta.json"))
    assert meta["format"] == "npz" and meta["weights_saved"] is False
    jidx = JaxIndex.load(str(tmp_path))
    assert jidx.extractor is None
    _assert_same(jidx, tidx)
    want = JaxIndex.from_descriptors(x, list(tidx.names), jcfg)
    _assert_same(want, tidx)                 # the JAX build's own bytes
    q = x[:4]
    js, ji = jidx.search(q)
    ws, wi = want.search(q)
    np.testing.assert_array_equal(np.asarray(ji), np.asarray(wi))
    np.testing.assert_array_equal(np.asarray(js), np.asarray(ws))


@pytest.mark.parametrize("d", [31, 39, 40])
@pytest.mark.parametrize("dtype", DTYPES)
def test_jax_save_loads_in_the_port(dtype, d, tmp_path):
    jcfg, tcfg = _cfgs(dtype)
    x = _rows(d)
    jidx = JaxIndex.from_descriptors(x, [f"im{i}" for i in range(N)], jcfg)
    jidx.save(str(tmp_path), streaming=False)
    tidx = Index.load(str(tmp_path), device="cpu")
    assert tidx.extractor is None and tidx.device.type == "cpu"
    _assert_same(jidx, tidx)
    twin = _port_twin(jidx, tcfg, x)
    assert torch.equal(tidx.descriptors, twin.descriptors)
    _assert_same_answers(tidx, twin, x[:4])
    # and back: the port's save of it is the reference's file again
    tidx.save(str(tmp_path / "again"))
    _assert_same(JaxIndex.load(str(tmp_path / "again")), tidx)


@pytest.mark.parametrize("kind", ["bfloat16", "int8", "refine"])
def test_regional_and_refine_stores(kind, tmp_path):
    dtype = {"bfloat16": "bfloat16", "int8": "int8", "refine": "int4"}[kind]
    jcfg, tcfg = _cfgs(dtype, **({"refine_dtype": "int8"}
                                 if kind == "refine" else {}))
    x = _rows(39)
    names = [f"im{i}" for i in range(N)]
    jidx = JaxIndex.from_descriptors(x, names, jcfg)
    tidx = Index.from_descriptors(x, names, tcfg, device="cpu")
    if kind != "refine":
        rng = np.random.default_rng(1)
        reg = rng.standard_normal((N, 5, 39)).astype(np.float32)
        reg /= np.linalg.norm(reg, axis=-1, keepdims=True)
        jax_attach(jidx, reg)
        attach_regional_store(tidx, reg)
        geom = np.arange(15, dtype=np.float32).reshape(5, 3)
        jidx.regional_geom, tidx.regional_geom = geom, geom
    jidx.save(str(tmp_path / "jax"), streaming=False)
    tidx.save(str(tmp_path / "port"))
    from_jax = Index.load(str(tmp_path / "jax"), device="cpu")
    from_port = JaxIndex.load(str(tmp_path / "port"))
    _assert_same(jidx, from_jax)
    _assert_same(from_port, tidx)
    if kind != "refine":
        np.testing.assert_array_equal(from_jax.regional_geom, geom)
        np.testing.assert_array_equal(from_port.regional_geom, geom)
    else:
        assert from_jax.has_refine_store
        scfg = tidx.cfg.search.replace(refine_enabled=True, rerank_depth=20)
        for a, b in zip(tidx.search(x[:3], scfg),
                        from_jax.search(x[:3], scfg)):
            np.testing.assert_array_equal(a, b)


def test_pq_view_round_trips(tmp_path):
    jcfg, tcfg = _cfgs("int4")
    x = _rows(40, n=N)
    names = [f"im{i}" for i in range(N)]
    jidx = JaxIndex.from_descriptors(x, names, jcfg)
    jview = jidx.build_pq(m=10, iters=3, depth=30)
    jidx.save(str(tmp_path / "jax"), streaming=False)
    tidx = Index.load(str(tmp_path / "jax"), device="cpu")
    view = tidx.pq
    assert view.depth == 30 and tidx.cfg.search.pq_depth == 30
    np.testing.assert_array_equal(view.codes.numpy(), np.asarray(jview.codes))
    assert tuple(view.packed.shape) == (CAPACITY, 8)
    assert not view.packed[:, 5:].any()
    np.testing.assert_array_equal(view.codebook.centroids.numpy(),
                                  np.asarray(jview.codebook.centroids))
    js, ji = jidx.search(x[:4])
    ts, ti = tidx.with_search(use_pallas=False).search(x[:4])
    np.testing.assert_array_equal(ti, np.asarray(ji))
    np.testing.assert_allclose(ts, np.asarray(js), rtol=0, atol=1e-5)
    tidx.save(str(tmp_path / "port"))
    assert np.load(tmp_path / "port" / "pq" / "pq.npz")["codes"].shape == (
        CAPACITY, 5)
    back = JaxIndex.load(str(tmp_path / "port"))
    np.testing.assert_array_equal(np.asarray(back.pq.codes),
                                  np.asarray(jview.codes))


def _tiny_cfg(dtype="bfloat16"):
    return PipelineConfig(
        extract=ExtractConfig(backbone="resnet18", image_size=32,
                              whiten=True, dtype="float32"),
        index=IndexConfig(dtype=dtype, row_tile=8))


def test_port_weights_round_trip(tmp_path):
    """The backbone's state_dict goes to the port's own file and comes back
    into a rebuilt extractor: equal weights and whitening, equal
    descriptors, and equal answers to images."""
    cfg = _tiny_cfg()
    ex = Extractor(cfg.extract.replace(whiten=False), seed=3, device="cpu")
    # weights and BN statistics no seeded initialization gives again
    gen = torch.Generator().manual_seed(11)
    randomize_bn(ex.model, gen)
    with torch.no_grad():
        for t in ex.model.parameters():
            t.add_(0.01 * torch.randn(t.shape, generator=gen))
    images = np.random.default_rng(0).integers(0, 256, (10, 32, 32, 3),
                                               dtype=np.uint8)
    raw = ex(images)
    from instsearch_torch.ops.whitening import fit_whitening
    ex.whitening = fit_whitening(raw, dim=8)
    idx = Index.from_descriptors(ex(images), [f"im{i}" for i in range(10)],
                                 cfg, extractor=ex)
    idx.save(str(tmp_path))
    meta = json.load(open(tmp_path / "meta.json"))
    assert meta["torch_weights"] == "torch_weights.pt" and meta["seed"] == 3
    back = Index.load(str(tmp_path), device="cpu")
    for a, b in zip(ex.model.state_dict().values(),
                    back.extractor.model.state_dict().values()):
        assert torch.equal(a, b)
    assert torch.equal(back.extractor.whitening.P, ex.whitening.P)
    np.testing.assert_array_equal(back.extractor(images).numpy(),
                                  ex(images).numpy())
    for a, b in zip(idx.query_images(images[:3]),
                    back.query_images(images[:3])):
        np.testing.assert_array_equal(a, b)
    # the reference reads it without the weights (weights_saved is false)
    jidx = JaxIndex.load(str(tmp_path))
    assert jidx.extractor is None and len(jidx.names) == 10


def test_refusals(tmp_path):
    """orbax stores and a JAX index whose weights were saved (orbax) loaded
    without ``extractor=`` raise and name the converter; the port's
    ``save(streaming=True)`` writes its own stream, which the reference does
    not read; with its own extractor the JAX index loads and takes the
    stored whitening."""
    jcfg, tcfg = _cfgs("int8")
    x = _rows(16)
    names = [f"im{i}" for i in range(N)]
    tidx = Index.from_descriptors(x, names, tcfg, device="cpu")
    tidx.save(str(tmp_path / "s"), streaming=True)
    assert json.load(open(tmp_path / "s" / "meta.json"))["format"] == \
        Index.STREAM_FORMAT
    jidx = JaxIndex.from_descriptors(x, names, jcfg)
    jidx.save(str(tmp_path / "orbax"), streaming=True)
    with pytest.raises(NotImplementedError, match="tools/orbax_to_port.py"):
        Index.load(str(tmp_path / "orbax"), device="cpu")
    # what JaxIndex.save reads of its extractor: the variables (written by
    # orbax), the whitening and the seed
    jcfg = JaxPipelineConfig.from_json(_tiny_cfg("int8").to_json())
    rng = np.random.default_rng(2)
    P = rng.standard_normal((16, 512)).astype(np.float32)
    mu = rng.standard_normal(512).astype(np.float32)
    jex = types.SimpleNamespace(
        variables={"params": {"w": jnp.ones((3, 3))}}, seed=0,
        whitening=JaxWhitening(P=jnp.asarray(P), mu=jnp.asarray(mu)))
    jidx = JaxIndex.from_descriptors(x, names, jcfg, extractor=jex)
    jidx.save(str(tmp_path / "weights"), streaming=False)
    assert json.load(open(tmp_path / "weights" / "meta.json"))[
        "weights_saved"]
    with pytest.raises(ValueError, match="orbax_to_port"):
        Index.load(str(tmp_path / "weights"), device="cpu")
    ex = Extractor(_tiny_cfg().extract.replace(whiten=False), device="cpu")
    got = Index.load(str(tmp_path / "weights"), extractor=ex)
    assert got.extractor is ex and got.device.type == "cpu"
    np.testing.assert_array_equal(ex.whitening.P.numpy(), P)
    np.testing.assert_array_equal(ex.whitening.mu.numpy(), mu)
    assert isinstance(ex.whitening, WhiteningParams)
    assert os.path.isdir(tmp_path / "weights" / "variables")
