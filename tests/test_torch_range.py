"""Range search and reconstruction (``Index.search_range``,
``Index.reconstruct``) against the JAX package on the same seeded rows:
200 rows in a capacity of 256 (row tile 8), D = 31 and 40.

What is compared, and the tolerances:
  * the oracle route against the JAX Index (its oracle on the CPU): members
    equal, their scores within 1e-5 (f32 sums in two orders; int8/int4
    equal), counts equal. No row of these stores scores within 1e-4 of the
    thresholds, so the two orders of the count pass cannot disagree.
  * the kernel route (the plain versions of K1-K3 on a CPU store) against
    the reference's top-k on its kernel route, the Pallas kernels in
    interpret mode, cut at the same threshold: int8/int4 equal, bf16 within
    1e-5; counts equal.
  * truncation (a count past ``max_results``), a subset, and the stored rows
    read back by names and by ids, equal to JAX's.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import instsearch_tpu.kernels as jax_kernels
from instsearch_tpu import IndexConfig as JaxIndexConfig
from instsearch_tpu import PipelineConfig as JaxPipelineConfig
from instsearch_tpu import SearchConfig as JaxSearchConfig
from instsearch_tpu.index import Index as JaxIndex
from instsearch_tpu.index import _topk_jit
from instsearch_torch import IndexConfig, PipelineConfig, SearchConfig
from instsearch_torch.index import Index
from instsearch_torch.parallel import make_mesh
from instsearch_torch.search import bruteforce

N, CAPACITY = 200, 256
TOL = 1e-5
TAU = 0.25
JAX_KERNELS = {"bfloat16": "topk_matmul", "int8": "topk_matmul_int8",
               "int4": "topk_matmul_int4"}


@functools.lru_cache(maxsize=None)
def _data(d: int):
    rng = np.random.default_rng(300 + d)
    x = rng.standard_normal((N, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = x[[2, 40, 90]] + 0.3 * rng.standard_normal((3, d)).astype(np.float32)
    return x, q


def _pair(dtype: str, d: int):
    x, _ = _data(d)
    names = [f"im{i}" for i in range(N)]
    icfg = dict(dtype=dtype, row_tile=8, capacity=CAPACITY)
    return (JaxIndex.from_descriptors(x, names, JaxPipelineConfig(
                index=JaxIndexConfig(**icfg), search=JaxSearchConfig())),
            Index.from_descriptors(x, names, PipelineConfig(
                index=IndexConfig(**icfg), search=SearchConfig()),
                device="cpu"))


def _clear_of(tidx, q, tau):
    """No stored row scores within 1e-4 of ``tau`` (f32 over the
    dequantized rows), so the count cannot depend on the order of sums."""
    rows = tidx.reconstruct(ids=list(range(N)))[:, :q.shape[1]]
    s = np.asarray(q, np.float64) @ rows.T.astype(np.float64)
    assert np.abs(s - tau).min() > 1e-4


def _assert_range_equal(got, want, exact: bool):
    (ts, ti, tc), (js, ji, jc) = got, want
    np.testing.assert_array_equal(tc, np.asarray(jc))
    np.testing.assert_array_equal(ti, np.asarray(ji))
    if exact:
        np.testing.assert_array_equal(ts, np.asarray(js))
    else:
        np.testing.assert_allclose(ts, np.asarray(js), rtol=0, atol=TOL)


@pytest.mark.parametrize("d", [31, 40])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "int8", "int4"])
def test_oracle_route_matches_jax(dtype, d):
    jidx, tidx = _pair(dtype, d)
    _, q = _data(d)
    _clear_of(tidx, q, TAU)
    got = tidx.with_search(use_pallas=False).search_range(q, TAU,
                                                          max_results=64)
    assert got[0].shape == got[1].shape == (3, 64)
    assert got[2].dtype == np.int32 and (got[2] > 0).all()
    _assert_range_equal(got, jidx.search_range(q, TAU, max_results=64),
                        exact=False)
    # members first, then padding; in f32 the members are the counted rows
    # (a bf16 or quantized store's members score the stored precision, its
    # counts f32, so a row near tau may fall on either side)
    for row, n in zip(got[1], got[2]):
        m = int((row >= 0).sum())
        assert (row[:m] >= 0).all() and (row[m:] == -1).all()
        if dtype == "float32":
            assert m == min(n, 64)


@pytest.mark.parametrize("dtype", ["bfloat16", "int8", "int4"])
def test_kernel_route_matches_jax_kernels(dtype, monkeypatch):
    jidx, tidx = _pair(dtype, 40)
    _, q = _data(40)
    name = JAX_KERNELS[dtype]
    monkeypatch.setattr(jax_kernels, name, functools.partial(
        getattr(jax_kernels, name), interpret=True))
    js, ji = _topk_jit(jidx.descriptors, jidx.ids, jnp.asarray(q),
                       jnp.asarray(jidx.num_valid, jnp.int32), jidx.scales,
                       k=64, use_pallas=True, int4=jidx.is_int4)
    keep = np.asarray(js) >= TAU
    want = (np.where(keep, js, -np.inf), np.where(keep, ji, -1),
            jidx.search_range(q, TAU, max_results=64)[2])
    got = tidx.search_range(q, TAU, max_results=64)
    _assert_range_equal(got, want, exact=dtype != "bfloat16")


def test_truncation_and_subset():
    """A count past max_results flags a cut list; a subset counts and
    returns its members only, as in the reference."""
    jidx, tidx = _pair("int8", 31)
    _, q = _data(31)
    got = tidx.search_range(q, -10.0, max_results=8)
    want = jidx.search_range(q, -10.0, max_results=8)
    np.testing.assert_array_equal(got[2], np.asarray(want[2]))
    assert (got[2] == N).all() and (got[1] >= 0).all()
    members = list(range(1, N, 4))
    for route in (False, True):
        got = tidx.with_search(use_pallas=route).search_range(
            q, 0.1, max_results=32, subset=tidx.make_subset(ids=members))
        want = jidx.search_range(q, 0.1, max_results=32,
                                 subset=jidx.make_subset(ids=members))
        np.testing.assert_array_equal(got[2], np.asarray(want[2]))
        assert set(got[1][got[1] >= 0].tolist()) <= set(members)
        if not route:
            _assert_range_equal(got, want, exact=False)
    # through a mesh of 8 CPU shards: the same members, counts and scores
    sub = tidx.make_subset(ids=members)
    one = tidx.search_range(q, 0.1, max_results=32, subset=sub)
    mesh = tidx.search_range(q, 0.1, max_results=32, subset=sub,
                             mesh=make_mesh(8, devices=["cpu"] * 8))
    for a, b in zip(mesh, one):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("d", [31, 40])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "int8", "int4"])
def test_reconstruct_matches_jax(dtype, d):
    jidx, tidx = _pair(dtype, d)
    names = ["im7", "im0", "im199", "im7"]
    got = tidx.reconstruct(names=names)
    assert got.shape == (4, jidx.dim) and got.dtype == np.float32
    np.testing.assert_array_equal(got, jidx.reconstruct(names=names))
    np.testing.assert_array_equal(tidx.reconstruct(ids=[7, 0, 199, 7]), got)
    assert tidx.reconstruct(names=[]).shape == (0, jidx.dim)
    with pytest.raises(KeyError, match="names not in the index"):
        tidx.reconstruct(names=["im7", "nope"])
    with pytest.raises(KeyError, match="ids not in the index"):
        tidx.reconstruct(ids=[N])
    with pytest.raises(ValueError, match="exactly one"):
        tidx.reconstruct()


@pytest.mark.parametrize("dtype", ["bfloat16", "int8", "int4"])
def test_count_pass_is_bounded_and_cut_independent(dtype, monkeypatch):
    """The count pass widens one chunk at a time: a budget of seven rows
    cuts the store into 37 chunks (never more than seven rows widened,
    checked on every chunk's product), and the counts equal the one-chunk
    pass's and the JAX Index's (no row within 1e-4 of ``TAU``)."""
    jidx, tidx = _pair(dtype, 40)
    _, q = _data(40)
    _clear_of(tidx, q, TAU)
    qs = tidx._match_query_dim(torch.from_numpy(q))
    thr = torch.full((3,), TAU)
    args = (tidx.descriptors, tidx.ids, qs, thr, tidx.scales)
    kw = dict(int4=tidx.is_int4, dim=tidx.dim)
    whole = bruteforce.range_count(*args, **kw)
    widened = []
    matmul = torch.Tensor.__matmul__

    def spy(a, b):
        widened.append(b.shape[1])
        return matmul(a, b)

    monkeypatch.setattr(bruteforce, "_RANGE_BUDGET", 8 * (3 + 40) * 7)
    monkeypatch.setattr(torch.Tensor, "__matmul__", spy)
    cut = bruteforce.range_count(*args, **kw)
    monkeypatch.undo()
    assert max(widened) <= 7 and len(widened) == -(-CAPACITY // 7)
    np.testing.assert_array_equal(cut.numpy(), whole.numpy())
    np.testing.assert_array_equal(
        whole.numpy(), np.asarray(jidx.search_range(q, TAU)[2]))
