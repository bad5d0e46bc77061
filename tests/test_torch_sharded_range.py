"""Range search through a mesh (``Index.search_range(mesh=)``,
``ShardedIndex.search_range``) against the JAX package's single-device
``search_range`` on the same seeded rows, mirroring
tests/distributed/test_sharded_range.py: 320 rows (row tile 8) over 8
CPU shards (``make_mesh(8, devices=["cpu"] * 8)``).

The members come from the sharded merge of the top-k, cut at the
threshold; the counts from each shard's pass over its own rows, summed
(f32 rows, f64 products: the counts of two cuts agree to f64 rounding).
What is compared, and the tolerances:
  * the oracle route (f32, bf16, int8, int4) and a subset against JAX's:
    counts equal, ids equal, scores within 1e-5 (f32 sums in two orders);
  * the kernel route (the plain versions of K1-K3 on CPU shards) against
    the port's own single-device route: counts, ids and scores equal (the
    merge of the same per-shard sums; K1-K3's rule on the card);
  * an l2 index's radius against JAX's and against a float64 distance
    count;
  * the process-group form at world size 1 on gloo: the counts pass
    through one ``all_reduce`` and equal the group-less mesh's.
"""
import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist

from instsearch_tpu import ExtractConfig as JaxExtractConfig
from instsearch_tpu import IndexConfig as JaxIndexConfig
from instsearch_tpu import PipelineConfig as JaxPipelineConfig
from instsearch_tpu import SearchConfig as JaxSearchConfig
from instsearch_tpu.index import Index as JaxIndex
from instsearch_torch import (ExtractConfig, IndexConfig, PipelineConfig,
                              SearchConfig)
from instsearch_torch.index import Index
from instsearch_torch.parallel import ShardedIndex, make_mesh

N, D = 320, 32
TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """Small CPU tensors in a worker process: one intra-op thread,
    restored afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _mesh(group=None):
    return make_mesh(8, devices=["cpu"] * 8, group=group)


def _unit(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _pair(rng, dtype="float32", metric="ip"):
    x = (_unit(rng, (N, D)) if metric == "ip" else
         (2.0 * rng.standard_normal((N, D))).astype(np.float32))
    icfg = dict(dtype=dtype, row_tile=8, metric=metric)
    scfg = dict(k=5, use_pallas=False, query_chunk=64)
    names = [f"im{i}" for i in range(N)]
    return (JaxIndex.from_descriptors(x, names, JaxPipelineConfig(
                extract=JaxExtractConfig(dtype="float32"),
                index=JaxIndexConfig(**icfg),
                search=JaxSearchConfig(**scfg))),
            Index.from_descriptors(x, names, PipelineConfig(
                extract=ExtractConfig(dtype="float32"),
                index=IndexConfig(**icfg), search=SearchConfig(**scfg)),
                device="cpu"), x)


def _assert_equal_to(got, want, exact=False):
    (ts, ti, tc), (js, ji, jc) = got, want
    np.testing.assert_array_equal(tc, np.asarray(jc))
    np.testing.assert_array_equal(ti, np.asarray(ji))
    if exact:
        np.testing.assert_array_equal(ts, np.asarray(js))
    else:
        np.testing.assert_allclose(ts, np.asarray(js), rtol=0, atol=TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8", "int4"])
def test_mesh_range_equals_single(rng, dtype):
    jidx, tidx, _ = _pair(rng, dtype)
    q = _unit(rng, (5, D))
    want = jidx.search_range(q, 0.2, max_results=64)
    got = tidx.search_range(q, 0.2, max_results=64, mesh=_mesh())
    assert got[2].dtype == np.int32 and (got[2] > 0).all()
    _assert_equal_to(got, want)
    # the kernel route's merge equals the single-device kernel route
    kern = tidx.with_search(use_pallas=True)
    _assert_equal_to(kern.search_range(q, 0.2, max_results=64,
                                       mesh=_mesh()),
                     kern.search_range(q, 0.2, max_results=64), exact=True)


def test_mesh_range_subset(rng):
    jidx, tidx, _ = _pair(rng)
    members = [f"im{j}" for j in range(0, N, 3)]
    q = _unit(rng, (3, D))
    want = jidx.search_range(q, 0.15, max_results=64,
                             subset=jidx.make_subset(names=members))
    sub = tidx.make_subset(names=members)
    got = tidx.search_range(q, 0.15, max_results=64, subset=sub,
                            mesh=_mesh())
    _assert_equal_to(got, want)
    # ShardedIndex.search_range takes the placed mask itself
    sidx = tidx.to_sharded(mesh=_mesh())
    s, i, c = sidx.search_range(q, 0.15, max_results=64,
                                mask=sidx.place_subset(sub))
    np.testing.assert_array_equal(i.numpy(), got[1])
    np.testing.assert_array_equal(c.numpy(), got[2])


def test_mesh_range_l2_radius(rng):
    jidx, tidx, x = _pair(rng, metric="l2")
    q = (2.0 * rng.standard_normal((3, D))).astype(np.float32)
    r = 8.0
    want = jidx.search_range(q, r, max_results=128)
    got = tidx.search_range(q, r, max_results=128, mesh=_mesh())
    np.testing.assert_array_equal(got[2], np.asarray(want[2]))
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))
    np.testing.assert_allclose(got[0], np.asarray(want[0]), rtol=1e-4,
                               atol=1e-3)
    d2 = ((q[:, None, :].astype(np.float64) - x[None]) ** 2).sum(-1)
    np.testing.assert_array_equal(got[2], (d2 <= r * r).sum(1))
    _assert_equal_to(got, tidx.search_range(q, r, max_results=128),
                     exact=True)


@pytest.fixture()
def world_of_one():
    """A gloo process group of one process on a free loopback port,
    destroyed afterwards."""
    if dist.is_initialized():
        pytest.fail("a process group is already up in this worker")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    yield dist.group.WORLD
    dist.destroy_process_group()


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_group_form_counts_through_all_reduce(rng, dtype, world_of_one,
                                              monkeypatch):
    _, tidx, _ = _pair(rng, dtype)
    q = _unit(rng, (4, D))
    reduced = []
    real = dist.all_reduce

    def counting(t, *a, **kw):
        reduced.append(tuple(t.shape))
        return real(t, *a, **kw)

    monkeypatch.setattr(dist, "all_reduce", counting)
    kw = dict(k=5, use_pallas=False, scales=tidx.scales, dim=tidx.dim)
    grouped = ShardedIndex(tidx.descriptors, tidx.ids,
                           mesh=_mesh(world_of_one), **kw)
    alone = ShardedIndex(tidx.descriptors, tidx.ids, mesh=_mesh(), **kw)
    got = grouped.search_range(q, 0.2, max_results=64)
    assert reduced == [(4,)]
    for a, b in zip(got, alone.search_range(q, 0.2, max_results=64)):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(got[2].numpy(),
                                  tidx.search_range(q, 0.2,
                                                    max_results=64)[2])
