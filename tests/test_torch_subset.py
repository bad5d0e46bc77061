"""Subset filters (``instsearch_torch/search/subset.py`` and the ``[1,
N_pad]`` mask through ``Index`` and ``ShardedIndex``) against the JAX
package on the same seeded rows.

The store holds 200 valid rows in a capacity of 256 (row tile 8), at D = 31
(the odd width: zero columns up to the kernels' multiple, int4 one zero
column inside its dim) and D = 40. The subset is every third row, so most
of a top-k's neighbours are masked out.

What is compared, and the tolerances:
  * ``make_subset`` by names, ids and mask: the mask equal to JAX's, the
    count, the refusals (``KeyError``, one spec, stale filters).
  * the oracle route (the port index's own config has ``use_pallas`` off)
    against the JAX Index, which takes its oracle on the CPU: ids equal,
    scores within 1e-5 (f32 sums in two orders; int8/int4 scores equal).
  * the kernel route (the plain versions of K1-K3 on a CPU store, K4's for
    the cascade) against the reference's composites with the Pallas kernels
    in interpret mode and the same mask: int8/int4 scores and ids equal, bf16
    within 1e-5 with ids equal except where JAX scores the two within 1e-5.
  * QE, re-rank, refine and the PQ cascade (the JAX view's codes) under a
    subset; fewer members than k; the sharded index's ``place_subset`` on
    ``["cpu"] * S`` (S = 1, 2, 8) against JAX's ``ShardedIndex``.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import instsearch_tpu.kernels as jax_kernels
import instsearch_tpu.kernels.pq_scan as jax_pq_scan
from instsearch_tpu import IndexConfig as JaxIndexConfig
from instsearch_tpu import PipelineConfig as JaxPipelineConfig
from instsearch_tpu import SearchConfig as JaxSearchConfig
from instsearch_tpu.index import Index as JaxIndex
from instsearch_tpu.index import _search_composite_jit
from instsearch_tpu.index import attach_regional_store as jax_attach
from instsearch_tpu.parallel import ShardedIndex as JaxShardedIndex
from instsearch_tpu.parallel import make_mesh as jax_mesh
from instsearch_tpu.search.pq_view import _pq_composite_jit
from instsearch_torch import IndexConfig, PipelineConfig, SearchConfig
from instsearch_torch.index import Index, attach_regional_store
from instsearch_torch.parallel import make_mesh
from instsearch_torch.search.pq_view import PQView
from instsearch_torch.search.subset import SubsetFilter

N, CAPACITY, K = 200, 256, 10
TOL = 1e-5
MEMBERS = list(range(0, N, 3))
JAX_KERNELS = {"bfloat16": "topk_matmul", "int8": "topk_matmul_int8",
               "int4": "topk_matmul_int4"}


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@functools.lru_cache(maxsize=None)
def _data(d: int):
    rng = np.random.default_rng(d)
    x = _unit(rng, N, d)
    q = x[[1, 5, 9, 30]] + 0.1 * rng.standard_normal((4, d)).astype(
        np.float32)
    return x, q


def _icfg(dtype: str, **kw) -> dict:
    return dict(dtype=dtype, row_tile=8, capacity=CAPACITY, **kw)


def _pair(dtype: str, d: int, search=None, **index):
    """(JAX Index, port Index) over the same rows and config."""
    x, _ = _data(d)
    names = [f"im{i}" for i in range(N)]
    scfg = search or {}
    jidx = JaxIndex.from_descriptors(x, names, JaxPipelineConfig(
        index=JaxIndexConfig(**_icfg(dtype, **index)),
        search=JaxSearchConfig(k=K, **scfg)))
    tidx = Index.from_descriptors(x, names, PipelineConfig(
        index=IndexConfig(**_icfg(dtype, **index)),
        search=SearchConfig(k=K, **scfg)), device="cpu")
    return jidx, tidx


def _assert_agree(js, ji, ts, ti, exact: bool):
    js, ji = np.asarray(js), np.asarray(ji)
    if exact:
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(ts, js)
        return
    for q in range(ji.shape[0]):
        jscore = dict(zip(ji[q].tolist(), js[q].tolist()))
        for a, b in zip(ji[q], ti[q]):
            if a != b:
                assert b in jscore and abs(jscore[a] - jscore[b]) < TOL
    np.testing.assert_allclose(ts, js, rtol=0, atol=TOL)


def _members_only(ids, members=MEMBERS):
    allowed = set(members)
    assert all(i in allowed for i in ids[ids >= 0].tolist())


# ---------------------------------------------------------------------------
@pytest.mark.parametrize("spec", ["names", "ids", "mask"])
def test_make_subset_matches_jax(spec):
    jidx, tidx = _pair("bfloat16", 40)
    if spec == "names":
        kw = {"names": [f"im{i}" for i in MEMBERS]}
    elif spec == "ids":
        kw = {"ids": MEMBERS}
    else:
        m = np.zeros(CAPACITY, bool)
        m[MEMBERS] = True
        m[N + 3] = True                  # a padding row: ANDed away
        kw = {"mask": m}
    jsub, tsub = jidx.make_subset(**kw), tidx.make_subset(**kw)
    assert isinstance(tsub, SubsetFilter)
    assert tsub.mask.dtype == torch.int8 and tuple(tsub.mask.shape) == (
        1, CAPACITY)
    np.testing.assert_array_equal(tsub.mask.numpy(), np.asarray(jsub.mask))
    assert (tsub.count, tsub.n_pad, tsub.layout_gen) == (
        jsub.count, jsub.n_pad, jsub.layout_gen) == (len(MEMBERS),
                                                     CAPACITY, 0)
    assert tsub.names == jsub.names


def test_subset_refusals():
    jidx, tidx = _pair("int8", 31)
    for idx in (jidx, tidx):
        with pytest.raises(KeyError, match="subset names not in the index"):
            idx.make_subset(names=["im1", "nope"])
        with pytest.raises(KeyError, match="subset ids not in the index"):
            idx.make_subset(ids=[1, N + 5])
        with pytest.raises(ValueError, match="exactly one"):
            idx.make_subset(names=["im1"], ids=[1])
        with pytest.raises(ValueError, match="padded row"):
            idx.make_subset(mask=np.ones(N, bool))
    # an ad hoc sequence of names or ids builds the filter on the spot
    _, q = _data(31)
    a = tidx.search(q, subset=[f"im{i}" for i in MEMBERS])
    b = tidx.search(q, subset=MEMBERS)
    np.testing.assert_array_equal(a[1], b[1])
    _members_only(a[1])


@pytest.mark.parametrize("mutation", ["add_in_place", "remove", "repad"])
def test_stale_filters_are_refused(mutation):
    """remove and a re-padding add make a filter stale in both packages; an
    add that fits the capacity does not (positions did not move)."""
    jidx, tidx = _pair("int4", 40)
    x, q = _data(40)
    subs = [idx.make_subset(ids=MEMBERS) for idx in (jidx, tidx)]
    for idx in (jidx, tidx):
        if mutation == "remove":
            idx.remove(["im3", "im4"])
        else:
            n = 8 if mutation == "add_in_place" else 64
            idx.add(descriptors=x[:n], names=[f"new{i}" for i in range(n)])
    assert tidx._layout_gen == jidx._layout_gen
    for idx, sub in zip((jidx, tidx), subs):
        if mutation == "add_in_place":
            _members_only(np.asarray(idx.search(q, subset=sub)[1]))
        else:
            with pytest.raises(ValueError, match="stale SubsetFilter"):
                idx.search(q, subset=sub)
    if mutation == "repad":
        assert tidx.descriptors.shape[0] == jidx.descriptors.shape[0] == \
            2 * CAPACITY


@pytest.mark.parametrize("d", [31, 40])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "int8", "int4"])
def test_oracle_route_matches_jax(dtype, d):
    jidx, tidx = _pair(dtype, d)
    _, q = _data(d)
    js, ji = jidx.search(q, subset=jidx.make_subset(ids=MEMBERS))
    ts, ti = tidx.with_search(use_pallas=False).search(
        q, subset=tidx.make_subset(ids=MEMBERS))
    np.testing.assert_array_equal(ti, np.asarray(ji))
    np.testing.assert_allclose(ts, np.asarray(js), rtol=0, atol=TOL)
    _members_only(ti)


def _jax_composite(jidx, q, mask, monkeypatch, dtype, **kw):
    """The reference's composite on its kernel route, the Pallas kernel of
    the store's kind in interpret mode."""
    name = JAX_KERNELS[dtype]
    monkeypatch.setattr(jax_kernels, name, functools.partial(
        getattr(jax_kernels, name), interpret=True))
    scfg = jidx.cfg.search
    args = dict(k=scfg.k, depth=0, qe_n=scfg.qe_n, qe_alpha=scfg.qe_alpha,
                use_pallas=True, do_qe=False, do_rerank=False,
                int4=jidx.is_int4)
    args.update(kw)
    return _search_composite_jit(
        jidx.descriptors, jidx.ids, jidx._match_query_dim(jnp.asarray(q)),
        jnp.asarray(jidx.num_valid, jnp.int32), jidx.scales, None, None,
        None, None, mask, **args)


@pytest.mark.parametrize("qe", [False, True], ids=["plain", "qe"])
@pytest.mark.parametrize("dtype", ["bfloat16", "int8", "int4"])
def test_kernel_route_matches_jax_kernels(dtype, qe, monkeypatch):
    jidx, tidx = _pair(dtype, 40, search=dict(qe_enabled=qe, qe_n=4))
    _, q = _data(40)
    js, ji = _jax_composite(jidx, q, jidx.make_subset(ids=MEMBERS).mask,
                            monkeypatch, dtype, do_qe=qe)
    ts, ti = tidx.search(q, subset=tidx.make_subset(ids=MEMBERS))
    # after QE the expanded query is an f32 sum in each library's order
    _assert_agree(js, ji, ts, ti, exact=dtype != "bfloat16" and not qe)
    _members_only(ti)


def test_qe_rerank_refine_under_a_subset():
    """alpha-QE (int8), the regional re-rank with the spatial vote (bf16)
    and the exact refine (int4 + int8 copy) on the oracle route, each under
    the subset, against the JAX Index."""
    _, q = _data(40)
    sub = dict(ids=MEMBERS)
    jidx, tidx = _pair("int8", 40, search=dict(qe_enabled=True, qe_n=4))
    js, ji = jidx.search(q, subset=jidx.make_subset(**sub))
    ts, ti = tidx.with_search(use_pallas=False).search(
        q, subset=tidx.make_subset(**sub))
    _assert_agree(js, ji, ts, ti, exact=False)
    _members_only(ti)

    rng = np.random.default_rng(7)
    reg = rng.standard_normal((N, 14, 40)).astype(np.float32)
    reg /= np.linalg.norm(reg, axis=-1, keepdims=True)
    qreg = reg[[1, 5, 9, 30]]
    rr = dict(rerank_enabled=True, rerank_depth=30, spatial_weight=0.5)
    jidx, tidx = _pair("bfloat16", 40, search=rr)
    from instsearch_tpu.ops.pooling import rmac_region_geometry
    jax_attach(jidx, reg)
    jidx.regional_geom = rmac_region_geometry(6, 6, 3)
    attach_regional_store(tidx, reg)
    tidx.regional_geom = jidx.regional_geom
    js, ji = jidx.search(q, query_regional=qreg,
                         subset=jidx.make_subset(**sub))
    ts, ti = tidx.with_search(use_pallas=False).search(
        q, query_regional=qreg, subset=tidx.make_subset(**sub))
    _assert_agree(js, ji, ts, ti, exact=False)
    _members_only(ti)

    jidx, tidx = _pair("int4", 40, search=dict(refine_enabled=True,
                                              rerank_depth=30),
                       refine_dtype="int8")
    js, ji = jidx.search(q, subset=jidx.make_subset(**sub))
    for route in (False, True):
        ts, ti = tidx.with_search(use_pallas=route).search(
            q, subset=tidx.make_subset(**sub))
        _assert_agree(js, ji, ts, ti, exact=False)
        _members_only(ti)


@pytest.mark.parametrize("kernel", [False, True], ids=["oracle", "kernel"])
def test_pq_cascade_under_a_subset(kernel, monkeypatch):
    """The cascade over the JAX view's codes: the mask applies at ADC
    selection, so all 32 candidates are members and the top 10 are filled
    (a filter after the re-score would keep about a third of them); the
    answers equal the reference's composite."""
    jidx, tidx = _pair("int4", 40, search=dict(qe_enabled=True, qe_n=3))
    _, q = _data(40)
    jview = jidx.build_pq(m=8, iters=3, depth=32)
    view = PQView.from_arrays(np.asarray(jview.codebook.centroids),
                              np.asarray(jview.codes), 32, device="cpu")
    tidx.pq = view
    tidx.cfg = tidx.cfg.replace(search=tidx.cfg.search.replace(pq_depth=32))
    jmask = jidx.make_subset(ids=MEMBERS).mask
    if kernel:
        monkeypatch.setattr(jax_pq_scan, "pq_topk", functools.partial(
            jax_pq_scan.pq_topk, interpret=True))
    js, ji = _pq_composite_jit(
        jview.codes, jview.codebook.centroids, jidx.descriptors, jidx.ids,
        jidx.scales, None, None, None, jnp.asarray(q),
        jnp.asarray(jidx.num_valid, jnp.int32), None, None, jmask, k=K,
        depth=32, qe_n=3, qe_alpha=3.0, do_qe=True, do_rerank=False,
        int4=True, use_pallas=kernel)
    ts, ti = tidx.with_search(use_pallas=kernel).search(
        q, subset=tidx.make_subset(ids=MEMBERS))
    _assert_agree(js, ji, ts, ti, exact=False)
    _members_only(ti)
    assert (ti >= 0).all()


@pytest.mark.parametrize("dtype", ["bfloat16", "int4"])
def test_fewer_members_than_k(dtype):
    """Five members, k = 10: the tail is (-inf, -1) on both routes, as in
    the reference."""
    jidx, tidx = _pair(dtype, 31)
    _, q = _data(31)
    few = [3, 50, 77, 120, 199]
    js, ji = jidx.search(q, subset=jidx.make_subset(ids=few))
    for route in (False, True):
        ts, ti = tidx.with_search(use_pallas=route).search(
            q, subset=tidx.make_subset(ids=few))
        assert (ti[:, 5:] == -1).all() and np.isneginf(ts[:, 5:]).all()
        assert sorted(ti[0, :5].tolist()) == few
        np.testing.assert_array_equal(np.asarray(ji)[:, 5:], ti[:, 5:])
        np.testing.assert_array_equal(np.sort(ti[:, :5], axis=1),
                                      np.sort(np.asarray(ji)[:, :5], axis=1))


@pytest.mark.parametrize("s", [1, 2, 8])
def test_place_subset_matches_jax(s):
    """``place_subset`` cuts the mask into each shard's [1, C] slice; the
    sharded search, QE search and re-rank under it equal JAX's
    ``ShardedIndex`` with its placed mask (ids equal; int8 scores equal on
    the kernel route, 1e-5 after QE) and the port's single-device search."""
    jidx, tidx = _pair("int8", 40)
    _, q = _data(40)
    jsub, tsub = jidx.make_subset(ids=MEMBERS), tidx.make_subset(ids=MEMBERS)
    sidx = tidx.to_sharded(mesh=make_mesh(s, devices=["cpu"] * s))
    placed = sidx.place_subset(tsub)
    c = CAPACITY // s
    assert len(placed) == s and all(tuple(p.shape) == (1, c)
                                    for p in placed)
    np.testing.assert_array_equal(torch.cat(placed, 1).numpy(),
                                  tsub.mask.numpy())
    jsidx = JaxShardedIndex(jidx.descriptors, jidx.ids, mesh=jax_mesh(s),
                            k=K, use_pallas=True, interpret=True,
                            scales=jidx.scales)
    jmask = jsidx.place_subset(jsub)
    got = sidx.search(q, mask=placed)
    _assert_agree(*jsidx.search(q, k=K, mask=jmask), *got, exact=True)
    _members_only(got[1].numpy())
    single = tidx.search(q, subset=tsub)
    _assert_agree(*single, got[0].numpy(), got[1].numpy(), exact=True)
    got = sidx.search_qe(q, qe_n=4, mask=tsub)
    _assert_agree(*jsidx.search_qe(q, k=K, qe_n=4, mask=jmask),
                  got[0].numpy(), got[1].numpy(), exact=False)
    _members_only(got[1].numpy())
    with pytest.raises(ValueError, match="different store"):
        sidx.place_subset(np.ones((1, CAPACITY + 8), np.int8))
