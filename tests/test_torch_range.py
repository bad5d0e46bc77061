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

import instsearch_tpu.kernels as jax_kernels
from instsearch_tpu import IndexConfig as JaxIndexConfig
from instsearch_tpu import PipelineConfig as JaxPipelineConfig
from instsearch_tpu import SearchConfig as JaxSearchConfig
from instsearch_tpu.index import Index as JaxIndex
from instsearch_tpu.index import _topk_jit
from instsearch_torch import IndexConfig, PipelineConfig, SearchConfig
from instsearch_torch.index import Index

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
    with pytest.raises(NotImplementedError, match="M7"):
        tidx.search_range(q, 0.1, mesh=object())


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
