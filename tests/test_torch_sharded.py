"""The port's sharded index (``instsearch_torch/parallel/``) against the JAX
package's ``ShardedIndex`` on the same seeded rows, and against the port's
own single-device ``Index``.

The JAX side runs on the eight virtual CPU devices of tests/conftest.py,
``make_mesh(S)``: with ``use_pallas=True, interpret=True`` (the kernel
route, the interpret-mode Pallas kernels) or the oracle. The port runs S
shards on ``["cpu"] * S`` (each takes the kernels' plain versions on the
kernel route), for S in {1, 2, 8}.

The store holds 440 valid rows padded to a capacity of 512 (row tile 8, 8
shards): at S = 8 the rows end inside shard 6 and shard 7 is all padding,
at S = 2 they end inside shard 1. Two rows are copies of rows in another
shard (300 of 10, 420 of 5), and two queries are those rows exactly, so
their top-2 are ties across shards: the lower global row must come first.

Tolerances. Ids equal. Scores: equal in int8/int4 on the kernel route
(exact integer sums, the query quantized bit for bit as JAX does); within
SCORE_TOL = 1e-5 in bf16/f32, on the oracle route and after alpha-QE (f32
sums of the two libraries in other orders). Against the port's
single-device ``Index``: equal, ids and scores (the same plain versions on
the same rows).
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import instsearch_torch.parallel.sharded_index as tsharded
from instsearch_tpu import IndexConfig as JaxIndexConfig
from instsearch_tpu import PipelineConfig as JaxPipelineConfig
from instsearch_tpu import SearchConfig as JaxSearchConfig
from instsearch_tpu.index import Index as JaxIndex
from instsearch_tpu.ops.pooling import rmac_region_geometry
from instsearch_tpu.parallel import ShardedIndex as JaxShardedIndex
from instsearch_tpu.parallel import make_mesh as jax_mesh
from instsearch_torch import IndexConfig, PipelineConfig, SearchConfig
from instsearch_torch.index import Index, attach_regional_store
from instsearch_torch.parallel import ShardedIndex, make_mesh

N, CAPACITY, D, K, R = 440, 512, 32, 7, 14
SCORE_TOL = 1e-5
SHARDS = (1, 2, 8)
DTYPES = ("bfloat16", "float32", "int8", "int4")
COPIES = ((10, 300), (5, 420))      # (row, its copy in another shard)


def _rows(d: int = D):
    rng = np.random.default_rng(29)
    x = rng.standard_normal((N, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    for src, dst in COPIES:
        x[dst] = x[src]
    q = x[:4] + 0.05 * rng.standard_normal((4, d)).astype(np.float32)
    q = np.concatenate([x[[src for src, _ in COPIES]], q])
    reg = rng.standard_normal((N, R, d)).astype(np.float32)
    reg /= np.linalg.norm(reg, axis=-1, keepdims=True)
    qreg = reg[:len(q)] + 0.05 * rng.standard_normal(
        (len(q), R, d)).astype(np.float32)
    return x, q, reg, qreg


def _cfgs(dtype: str, refine: bool = False):
    icfg = dict(dtype=dtype, row_tile=8, num_shards=8, capacity=CAPACITY,
                refine_dtype="int8" if refine else "")
    return (JaxPipelineConfig(index=JaxIndexConfig(**icfg),
                              search=JaxSearchConfig(k=K)),
            PipelineConfig(index=IndexConfig(**icfg),
                           search=SearchConfig(k=K)))


@functools.lru_cache(maxsize=None)
def _pair(dtype: str, d: int = D, regional: bool = False,
          refine: bool = False):
    """(JAX Index, port Index) over the same rows; with ``regional`` the
    port's regional store attached (the JAX side takes its bytes)."""
    x, _, reg, _ = _rows(d)
    names = [f"r{i}" for i in range(N)]
    jcfg, tcfg = _cfgs(dtype, refine)
    jidx = JaxIndex.from_descriptors(x, names, jcfg)
    tidx = Index.from_descriptors(x, names, tcfg, device="cpu")
    if regional:
        attach_regional_store(tidx, reg)
        tidx.regional_geom = rmac_region_geometry(6, 6, 3)
    return jidx, tidx


def _jax_sharded(jidx, tidx, s: int, kernel: bool):
    kw = {}
    reg = tidx.regional
    if reg is not None:
        # the port's regional bytes: bf16 values pass through f32 exactly
        kw = dict(regional=(jnp.asarray(reg.numpy()) if reg.dtype == torch.int8
                            else jnp.asarray(reg.float().numpy()).astype(
                                jnp.bfloat16)),
                  regional_scales=(None if tidx.regional_scales is None else
                                   jnp.asarray(tidx.regional_scales.numpy())),
                  regional_geom=tidx.regional_geom)
    return JaxShardedIndex(jidx.descriptors, jidx.ids, mesh=jax_mesh(s), k=K,
                           use_pallas=kernel, interpret=kernel,
                           scales=jidx.scales, int4=jidx.is_int4, **kw)


def _port_sharded(tidx, s: int, kernel: bool):
    return tidx.to_sharded(mesh=make_mesh(s, devices=["cpu"] * s),
                           use_pallas=kernel)


def _agree(got, want, exact: bool):
    (ts, ti), (js, ji) = got, want
    ti, ts = np.asarray(ti), np.asarray(ts)
    np.testing.assert_array_equal(ti, np.asarray(ji))
    if exact:
        np.testing.assert_array_equal(ts, np.asarray(js))
    else:
        np.testing.assert_allclose(ts, np.asarray(js), rtol=0, atol=SCORE_TOL)


def _exact(dtype: str, kernel: bool) -> bool:
    return kernel and dtype in ("int8", "int4")


@pytest.mark.parametrize("kernel", [True, False], ids=["kernel", "oracle"])
@pytest.mark.parametrize("s", SHARDS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_search_matches_jax_and_single_device(dtype, s, kernel):
    jidx, tidx = _pair(dtype)
    _, q, _, _ = _rows()
    sidx = _port_sharded(tidx, s, kernel)
    got = sidx.search(q)
    _agree(got, _jax_sharded(jidx, tidx, s, kernel).search(q, k=K),
           _exact(dtype, kernel))
    single = tidx.with_search(use_pallas=kernel).search(q)
    _agree(got, single, exact=True)
    # ties across shards: the lower global row first
    for row, (src, dst) in enumerate(COPIES):
        assert got[1][row, :2].tolist() == [src, dst]


@pytest.mark.parametrize("kernel", [True, False], ids=["kernel", "oracle"])
@pytest.mark.parametrize("s", SHARDS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_search_qe_matches_jax_and_single_device(dtype, s, kernel):
    jidx, tidx = _pair(dtype)
    _, q, _, _ = _rows()
    got = _port_sharded(tidx, s, kernel).search_qe(q, qe_n=5, alpha=3.0)
    want = _jax_sharded(jidx, tidx, s, kernel).search_qe(q, k=K, qe_n=5,
                                                         alpha=3.0)
    # the expanded query is an f32 sum in each library's order, so even
    # int8/int4 scores may differ in the last bit of the query's scale
    _agree(got, want, exact=False)
    single = tidx.with_search(use_pallas=kernel).search(
        q, tidx.cfg.search.replace(qe_enabled=True, qe_n=5, qe_alpha=3.0))
    _agree(got, single, exact=True)


@pytest.mark.parametrize("kernel", [True, False], ids=["kernel", "oracle"])
@pytest.mark.parametrize("s", SHARDS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_expand_queries_matches_jax(dtype, s, kernel):
    """The expanded queries themselves: f32, within SCORE_TOL of JAX's (its
    rows' weights are the candidates' scores), equal across shard counts."""
    jidx, tidx = _pair(dtype)
    _, q, _, _ = _rows()
    got = _port_sharded(tidx, s, kernel).expand_queries(q, qe_n=5)
    want = np.asarray(_jax_sharded(jidx, tidx, s, kernel).expand_queries(
        q, qe_n=5))
    assert got.shape == (len(q), tidx.store_dim) and got.dtype == torch.float32
    np.testing.assert_allclose(got[:, :D].numpy(), want[:, :D], rtol=0,
                               atol=SCORE_TOL)
    one = _port_sharded(tidx, 1, kernel).expand_queries(q, qe_n=5)
    np.testing.assert_array_equal(got.numpy(), one.numpy())


@pytest.mark.parametrize("s", SHARDS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_full_ranking_matches_jax_and_single_device(dtype, s):
    jidx, tidx = _pair(dtype)
    _, q, _, _ = _rows()
    sidx = _port_sharded(tidx, s, True)
    got = sidx.full_ranking(q)
    assert got.shape == (len(q), N)
    np.testing.assert_array_equal(got, tidx.full_ranking(q))
    np.testing.assert_array_equal(
        got, _jax_sharded(jidx, tidx, s, False).full_ranking(q))
    scores = sidx.all_scores(q)
    assert scores.shape == (len(q), CAPACITY)
    assert bool(torch.isneginf(scores[:, N:]).all())


@pytest.mark.parametrize("kernel", [True, False], ids=["kernel", "oracle"])
@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_k_past_shard_rows(dtype, kernel):
    """k = 100 over 8 shards of 64 rows: each shard selects its 64 and pads
    back to 100 with (-inf, -1); the merge equals JAX's and one device's."""
    jidx, tidx = _pair(dtype)
    _, q, _, _ = _rows()
    got = _port_sharded(tidx, 8, kernel).search(q, k=100)
    want = _jax_sharded(jidx, tidx, 8, kernel).search(q, k=100)
    _agree(got, want, _exact(dtype, kernel))
    single = tidx.with_search(use_pallas=kernel).search(
        q, tidx.cfg.search.replace(k=100))
    _agree(got, single, exact=True)


@pytest.mark.parametrize("s", SHARDS)
def test_int4_odd_width(s):
    """D = 33 in int4 (the reference counts one zero column, the port
    more): the oracle route against JAX's (JAX's int4 kernel takes no odd
    width), both routes against the port's single device."""
    jidx, tidx = _pair("int4", d=33)
    _, q, _, _ = _rows(33)
    oracle = _port_sharded(tidx, s, False).search(q)
    _agree(oracle, _jax_sharded(jidx, tidx, s, False).search(q, k=K), False)
    for kernel, got in ((False, oracle),
                        (True, _port_sharded(tidx, s, True).search(q))):
        _agree(got, tidx.with_search(use_pallas=kernel).search(q), True)


@pytest.mark.parametrize("s", SHARDS)
@pytest.mark.parametrize("spatial", [0.0, 0.5], ids=["rerank", "spatial"])
@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_search_rerank_matches_jax_and_single_device(dtype, spatial, s):
    """The regional re-rank on the kernel route over a bf16 store (bf16
    regional store) and an int8 one (int8 regional store with per-(row,
    region) scales), depth 80 (past a shard's 64 rows at S = 8: each shard
    gives all its rows), with and without the spatial vote. Fused scores
    within SCORE_TOL of JAX's (the port sums them in the single-device
    stage's order), equal to the single-device stage's."""
    jidx, tidx = _pair(dtype, regional=True)
    _, q, _, qreg = _rows()
    got = _port_sharded(tidx, s, True).search_rerank(
        q, qreg, k=K, depth=80, spatial_weight=spatial)
    want = _jax_sharded(jidx, tidx, s, True).search_rerank(
        q, qreg, k=K, depth=80, spatial_weight=spatial)
    _agree(got, want, exact=False)
    single = tidx.search(q, tidx.cfg.search.replace(
        rerank_enabled=True, rerank_depth=80, spatial_weight=spatial),
        query_regional=qreg)
    _agree(got, single, exact=True)
    # k past the depth (and, at S = 1, past the gathered width): the slots
    # past the top-depth members come back (-inf, -1)
    s_pad, i_pad = _port_sharded(tidx, s, True).search_rerank(
        q, qreg, k=90, depth=80, spatial_weight=spatial)
    assert (i_pad[:, 80:] == -1).all() and bool(torch.isneginf(
        s_pad[:, 80:]).all()) and (i_pad[:, :80] >= 0).all()


@pytest.mark.parametrize("s", SHARDS)
def test_refine_matches_jax_and_single_device(s):
    """The exact refine over an int4 store's one-region int8 copy: the query
    its own region, no global term (fuse weight 0)."""
    jidx, tidx = _pair("int4", refine=True)
    _, q, _, _ = _rows()
    sidx = _port_sharded(tidx, s, True)
    got = sidx.search_refine(q, k=K, depth=30)
    jsidx = JaxShardedIndex(jidx.descriptors, jidx.ids, mesh=jax_mesh(s),
                            k=K, use_pallas=True, interpret=True,
                            scales=jidx.scales, int4=True,
                            regional=jidx.regional,
                            regional_scales=jidx.regional_scales)
    q32 = jnp.asarray(q)
    _agree(got, jsidx.search_rerank(q32, q32[:, None, :], k=K, depth=30,
                                    fuse_weight=0.0), exact=False)
    single = tidx.search(q, tidx.cfg.search.replace(refine_enabled=True,
                                                    rerank_depth=30))
    _agree(got, single, exact=True)


def test_padding_shard_takes_no_selection(monkeypatch):
    """At S = 8 the last shard holds only padding: it answers (-inf, -1)
    without a kernel call (7 calls for 8 shards), and a store's slices are
    views of it, not copies."""
    _, tidx = _pair("bfloat16")
    _, q, _, _ = _rows()
    sidx = _port_sharded(tidx, 8, True)
    assert [sh.num_valid for sh in sidx.shards] == [64] * 6 + [56, 0]
    base = tidx.descriptors.untyped_storage().data_ptr()
    assert all(sh.x.untyped_storage().data_ptr() == base
               for sh in sidx.shards)
    calls = []
    real = tsharded.topk_matmul
    monkeypatch.setattr(tsharded, "topk_matmul",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    s, i = sidx.search(q)
    assert len(calls) == 7
    assert int(i.max()) < N


def test_sharded_index_refusals():
    """Layouts the shards cannot take raise ValueError (the stages not
    ported yet: test_torch_sharded_slice.py)."""
    _, tidx = _pair("int8")
    with pytest.raises(ValueError, match="not divisible"):
        ShardedIndex(tidx.descriptors, tidx.ids,
                     mesh=make_mesh(3, devices=["cpu"] * 3),
                     scales=tidx.scales)
    with pytest.raises(ValueError, match="scales"):
        ShardedIndex(tidx.descriptors, tidx.ids,
                     mesh=make_mesh(2, devices=["cpu"] * 2))
    with pytest.raises(ValueError, match="local rows"):
        ShardedIndex(tidx.descriptors[:256], tidx.ids,
                     mesh=make_mesh(2, devices=["cpu"] * 2),
                     scales=tidx.scales[:, :256])
    sidx = _port_sharded(tidx, 2, True)
    with pytest.raises(ValueError, match="regional"):
        sidx.search_rerank(np.zeros((1, D), np.float32),
                           np.zeros((1, R, D), np.float32))
    with pytest.raises(ValueError, match="width"):
        sidx.search(np.zeros((1, D + 1), np.float32))
