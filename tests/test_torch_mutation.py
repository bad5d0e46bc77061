"""The live index (``Index.add``, ``remove``, ``merge_from`` and the PQ
view's ``absorb_add``/``absorb_remove``) against the JAX package: the same
sequence of mutations on the same seeded rows through both.

The sequence: 200 rows in a capacity of 256 (row tile 8); ``add`` 40 rows
in place; ``add`` 40 more past the capacity (the store re-pads to 512,
every int8/int4 row dequantized and quantized again); ``remove`` 12 names,
holes below the new count and rows of the tail; ``add`` 10 again;
``merge_from`` a donor of 30 rows. After each step the stores must be
byte-equal up to ``dim`` (the port's zero columns past it are zero; int4
compared by unpacked components, since the port pairs other components in
a byte), stale rows past the count included, with ids, names and scales
equal, and the oracle route's answers equal, unfiltered, under a subset of
the mutated positions and by range search with it (ids and counts equal,
scores within 1e-5: f32 sums in two orders; int8/int4 equal). The
regional (R-MAC, bf16 and int8) and exact-refine stores ride along; the
PQ view's codes equal the reference's, and ``packed`` is ``codes`` padded
to words.
"""
import functools

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
from instsearch_torch import (ExtractConfig, IndexConfig, PipelineConfig,
                              SearchConfig)
from instsearch_torch.extractor import Extractor
from instsearch_torch.index import Index, attach_regional_store
from instsearch_torch.ops.quantize import unpack_int4
from instsearch_torch.search.pq_view import PQView

N, CAPACITY, K = 200, 256, 10
TOL = 1e-5
REMOVE = ["im3", "im17", "im18", "im100", "im199", "a0", "a39", "b5",
          "b37", "b38", "b39", "im150"]


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@functools.lru_cache(maxsize=None)
def _data(d: int):
    rng = np.random.default_rng(100 + d)
    return (_unit(rng, N, d), _unit(rng, 40, d), _unit(rng, 40, d),
            _unit(rng, 10, d), _unit(rng, 30, d), _unit(rng, 5, d))


def _cfgs(dtype: str, **index):
    icfg = dict(dtype=dtype, row_tile=8, capacity=CAPACITY, **index)
    return (JaxPipelineConfig(index=JaxIndexConfig(**icfg),
                              search=JaxSearchConfig(k=K)),
            PipelineConfig(index=IndexConfig(**icfg),
                           search=SearchConfig(k=K)))


def _pair(dtype: str, rows, names, **index):
    jcfg, tcfg = _cfgs(dtype, **index)
    return (JaxIndex.from_descriptors(rows, names, jcfg),
            Index.from_descriptors(rows, names, tcfg, device="cpu"))


def _components(idx, jax_side: bool) -> np.ndarray:
    """The stored values up to ``dim`` (int4 unpacked)."""
    if jax_side:
        x = idx.descriptors
        return np.asarray(jax_unpack_int4(x) if idx.is_int4
                          else x.astype(jnp.float32) if x.dtype ==
                          jnp.bfloat16 else x)
    x = unpack_int4(idx.descriptors) if idx.is_int4 else idx.descriptors
    assert not x[:, idx.dim:].any()                # the zero columns
    return x[:, :idx.dim].float().numpy() if x.dtype == torch.bfloat16 \
        else x[:, :idx.dim].numpy()


def _assert_same(jidx, tidx, q):
    assert tidx.dim == jidx.dim
    np.testing.assert_array_equal(_components(tidx, False),
                                  _components(jidx, True))
    np.testing.assert_array_equal(tidx.ids.numpy(), np.asarray(jidx.ids))
    assert tidx.names == list(jidx.names)
    if jidx.scales is not None:
        np.testing.assert_array_equal(tidx.scales.numpy(),
                                      np.asarray(jidx.scales))
    for mine, ref in ((tidx.regional, jidx.regional),
                      (tidx.regional_scales, jidx.regional_scales)):
        assert (mine is None) == (ref is None)
        if mine is not None:
            np.testing.assert_array_equal(
                mine.float().numpy(), np.asarray(ref, np.float32))
    assert tidx._layout_gen == jidx._layout_gen
    assert tidx.cfg.index.capacity == jidx.cfg.index.capacity
    oracle = tidx.with_search(use_pallas=False)
    js, ji = jidx.search(q)
    ts, ti = oracle.search(q)
    np.testing.assert_array_equal(ti, np.asarray(ji))
    np.testing.assert_allclose(ts, np.asarray(js), rtol=0, atol=TOL)
    # a subset over the mutated positions (every third surviving name) and
    # range search with it: the same members, scores and exact counts
    members = tidx.names[::3]
    js, ji = jidx.search(q, subset=jidx.make_subset(names=members))
    ts, ti = oracle.search(q, subset=oracle.make_subset(names=members))
    np.testing.assert_array_equal(ti, np.asarray(ji))
    np.testing.assert_allclose(ts, np.asarray(js), rtol=0, atol=TOL)
    jr = jidx.search_range(q, 0.2, max_results=32,
                           subset=jidx.make_subset(names=members))
    tr = oracle.search_range(q, 0.2, max_results=32,
                             subset=oracle.make_subset(names=members))
    np.testing.assert_array_equal(tr[2], np.asarray(jr[2]))
    np.testing.assert_array_equal(tr[1], np.asarray(jr[1]))
    np.testing.assert_allclose(tr[0], np.asarray(jr[0]), rtol=0, atol=TOL)


@pytest.mark.parametrize("d", [31, 40])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "int8", "int4"])
def test_mutation_sequence_matches_jax(dtype, d):
    x, a, b, c, donor, q = _data(d)
    jidx, tidx = _pair(dtype, x, [f"im{i}" for i in range(N)])
    steps = [
        lambda idx: idx.add(descriptors=a, names=[f"a{i}" for i in range(40)]),
        lambda idx: idx.add(descriptors=b, names=[f"b{i}" for i in range(40)]),
        lambda idx: idx.remove(REMOVE),
        lambda idx: idx.add(descriptors=c, names=[f"c{i}" for i in range(10)]),
    ]
    for step, n_pad in zip(steps, (CAPACITY, 512, 512, 512)):
        assert step(tidx) == step(jidx)
        assert tidx.descriptors.shape[0] == n_pad
        _assert_same(jidx, tidx, q)
    jd, td = _pair(dtype, donor, [f"d{i}" for i in range(30)])
    assert tidx.merge_from(td) == jidx.merge_from(jd) == 30
    _assert_same(jidx, tidx, q)
    assert tidx.num_valid == N + 40 + 40 - len(REMOVE) + 10 + 30
    # every removed name is gone; survivors' ids map back to their names
    s, i = tidx.search(np.concatenate([x[[3, 17, 100]], a[[0, 39]]]))
    assert not {tidx.name_of(v) for v in i.reshape(-1)} & set(REMOVE)
    with pytest.raises(KeyError, match="not in index"):
        tidx.remove(["im3"])


def test_remove_moves_rows_verbatim():
    """The tail's survivors land in the holes in ascending order, their
    bytes unchanged (no quantization), and unknown names leave the index as
    it was."""
    x, *_ = _data(40)
    _, tidx = _pair("int8", x, [f"im{i}" for i in range(N)])
    before = tidx.descriptors.clone(), tidx.scales.clone()
    with pytest.raises(KeyError):
        tidx.remove(["im1", "missing"])
    assert tidx.num_valid == N and torch.equal(tidx.descriptors, before[0])
    assert tidx.remove(["im2", "im5", "im198"]) == 3
    # holes 2 and 5 take the tail's survivors 197 and 199; 198 was removed
    assert tidx.names[2] == "im197" and tidx.names[5] == "im199"
    assert torch.equal(tidx.descriptors[2], before[0][197])
    assert torch.equal(tidx.scales[0, 5], before[1][0, 199])
    assert (tidx.ids[N - 3:] == -1).all() and tidx._layout_gen == 1
    np.testing.assert_array_equal(tidx.reconstruct(names=["im199"]),
                                  tidx.reconstruct(ids=[199]))


@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_regional_store_rides_along(kind):
    """An R-MAC re-rank store (bf16 over a bf16 index, int8 over int8) moves
    with remove and grows with merge_from (the donor's dequantized regional
    rows) exactly as the reference's; a descriptor-only add is refused."""
    dtype = "bfloat16" if kind == "bf16" else "int8"
    x, _, _, _, donor, q = _data(40)
    rng = np.random.default_rng(5)
    reg = rng.standard_normal((N, 4, 40)).astype(np.float32)
    reg /= np.linalg.norm(reg, axis=-1, keepdims=True)
    dreg = reg[:30] * 0.5
    jidx, tidx = _pair(dtype, x, [f"im{i}" for i in range(N)])
    jd, td = _pair(dtype, donor, [f"d{i}" for i in range(30)])
    for j, t, r in ((jidx, tidx, reg), (jd, td, dreg)):
        jax_attach(j, r)
        attach_regional_store(t, r)
    for idx in (jidx, tidx):
        idx.remove(["im4", "im9", "im199"])
    _assert_same(jidx, tidx, q)
    with pytest.raises(ValueError, match="needs image paths"):
        tidx.add(descriptors=x[:2], names=["z0", "z1"])
    assert tidx.merge_from(td) == jidx.merge_from(jd) == 30
    _assert_same(jidx, tidx, q)


@pytest.mark.parametrize("d", [39, 40])
def test_refine_store_rides_along(d):
    """The exact-refine copy (int4 index, int8 copy) grows from the added
    rows, in place and across a re-pad, and follows the moves."""
    x, a, b, _, _, q = _data(d)
    jidx, tidx = _pair("int4", x, [f"im{i}" for i in range(N)],
                       refine_dtype="int8")
    for step in (lambda i: i.add(descriptors=a,
                                 names=[f"a{n}" for n in range(40)]),
                 lambda i: i.add(descriptors=b,
                                 names=[f"b{n}" for n in range(40)]),
                 lambda i: i.remove(REMOVE)):
        step(jidx)
        step(tidx)
        _assert_same(jidx, tidx, q)
    scfg = tidx.cfg.search.replace(refine_enabled=True, rerank_depth=20)
    js, ji = jidx.search(q, jidx.cfg.search.replace(refine_enabled=True,
                                                    rerank_depth=20))
    ts, ti = tidx.with_search(use_pallas=False).search(q, scfg)
    np.testing.assert_array_equal(ti, np.asarray(ji))
    np.testing.assert_allclose(ts, np.asarray(js), rtol=0, atol=TOL)


def test_pq_view_absorbs_add_and_remove():
    """The view over the JAX view's codes absorbs an add in place, an add
    past capacity (codes grow with zero rows, the reference's window of
    rows re-encoded) and a remove: the codes equal the reference's, and
    ``packed`` is ``codes`` padded to words; the cascade answers as JAX's,
    and a row just added is found."""
    x, a, b, _, _, q = _data(40)
    jidx, tidx = _pair("int4", x, [f"im{i}" for i in range(N)])
    jview = jidx.build_pq(m=10, iters=3, depth=40)
    tidx.pq = PQView.from_arrays(np.asarray(jview.codebook.centroids),
                                 np.asarray(jview.codes), 40, device="cpu")
    tidx.cfg = tidx.cfg.replace(search=tidx.cfg.search.replace(pq_depth=40))
    for step in (lambda i: i.add(descriptors=a[:3],
                                 names=[f"a{n}" for n in range(3)]),
                 lambda i: i.add(descriptors=b,
                                 names=[f"b{n}" for n in range(40)]),
                 lambda i: i.remove(["im0", "im7", "a1", "b30", "b39"]),
                 lambda i: i.add(descriptors=a[3:20],
                                 names=[f"a{n}" for n in range(3, 20)])):
        step(jidx)
        step(tidx)
        view = tidx.pq
        assert tuple(view.packed.shape) == (tidx.descriptors.shape[0], 8)
        np.testing.assert_array_equal(view.codes.numpy(),
                                      np.asarray(jidx.pq.codes))
        assert not view.packed[:, 5:].any()
        _assert_same(jidx, tidx, q)
    s, i = tidx.search(a[10:15])
    assert [tidx.name_of(v) for v in i[:, 0]] == [f"a{n}"
                                                  for n in range(10, 15)]


def _tiny_extractor(seed: int):
    return Extractor(ExtractConfig(backbone="resnet18", image_size=32),
                     seed=seed, device="cpu")


def test_merge_from_refusals():
    """Every refusal of the reference: the index itself, another metric,
    another dim, another extraction config, extractors of other weights or
    whitening, shared names, another regional-store kind or region count.
    Each leaves the index unchanged."""
    x, _, _, _, donor, _ = _data(40)
    names = [f"im{i}" for i in range(N)]
    _, idx = _pair("bfloat16", x, names)
    _, other = _pair("bfloat16", donor, [f"d{i}" for i in range(30)])

    def refused(o, match):
        with pytest.raises(ValueError, match=match):
            idx.merge_from(o)
        assert idx.num_valid == N

    refused(idx, "into itself")
    l2 = Index.from_descriptors(donor, other.names, other.cfg, device="cpu")
    l2.cfg = l2.cfg.replace(index=l2.cfg.index.replace(metric="l2"))
    refused(l2, "metric mismatch")
    _, narrow = _pair("bfloat16", donor[:, :32], other.names)
    refused(narrow, "dim mismatch")
    other_extract = Index.from_descriptors(
        donor, other.names, other.cfg.replace(
            extract=other.cfg.extract.replace(gem_p=2.0)), device="cpu")
    refused(other_extract, "extraction configs differ")
    idx.extractor, other.extractor = _tiny_extractor(0), _tiny_extractor(1)
    refused(other, "fingerprints differ")
    other.extractor = _tiny_extractor(0)
    other.extractor.whitening = (torch.eye(3), torch.zeros(3))
    refused(other, "fingerprints differ")
    other.extractor.whitening = None
    _, dup = _pair("bfloat16", donor, ["im5"] + other.names[1:])
    refused(dup, "duplicate names")
    regional = np.ones((30, 4, 40), np.float32) / np.sqrt(40)
    attach_regional_store(other, regional)
    refused(other, "regional-store kinds differ")
    attach_regional_store(idx, np.ones((N, 3, 40), np.float32) / np.sqrt(40))
    refused(other, "region counts differ")
    attach_regional_store(idx, np.ones((N, 4, 40), np.float32) / np.sqrt(40))
    assert idx.merge_from(other) == 30
