"""Widths, depths and PQ sizes the reference serves, held in the port.

The Hopper kernels read rows as 16-byte vectors (K1: D % 8, K2: D % 16,
K3: D % 32 components), keep at most ``K_MAX`` entries a list and read a PQ
row's code bytes as 4-byte words. The port's ``Index`` therefore stores
zero columns up to those widths (``dim`` stays the descriptor width), sends
a k past ``K_MAX`` to the scoring oracle, as the reference sends a k past
its tile, and ``PQView`` pads its codes with zero bytes whose lookup-table
rows are zeros. None of that may change a result:

* D = 31 (a whitening clamped to 32 images) in bf16, int8 and int4: the
  port's ids equal the JAX ``Index``'s on the oracle route of each side; on
  the kernel route the port's plain versions over the padded store equal
  the interpret-mode JAX kernels over the unpadded one (K2/K3 bit for bit:
  their sums are exact integers; K1 by ``check_against_plain`` at 1e-5,
  f32 sums in two orders).
* k = 2000 on a 3,000-row store: the JAX ``Index``'s ids, scores within
  1e-5; ids may differ only where JAX's own scores of the two are within
  1e-5 (both sides are f32 products summed in other orders).
* ``build_pq`` at D = 96 (M = 12, 6 code bytes padded to 8): the padded
  scan equals the unpadded plain version bit for bit.
* On ``meta`` stores (no data, no CUDA) every width reaches the wrappers'
  CUDA-operand check and never a shape refusal; k = 2000 takes the oracle.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import instsearch_tpu.kernels as jax_kernels
import instsearch_torch.index as tindex
from instsearch_tpu.config import IndexConfig, PipelineConfig, SearchConfig
from instsearch_tpu.index import Index as JaxIndex
from instsearch_torch import PipelineConfig as TorchPipelineConfig
from instsearch_torch.index import Index, _topk_raw
from instsearch_torch.kernels.pq_scan import pq_topk, pq_topk_reference
from instsearch_torch.kernels.topk_matmul import (K_MAX, check_against_plain,
                                                  check_exact)
from instsearch_torch.ops.pq import PQCodebook
from instsearch_torch.search.pq_view import PQView

TOL = 1e-5
JAX_KERNELS = {"bfloat16": "topk_matmul", "int8": "topk_matmul_int8",
               "int4": "topk_matmul_int4"}


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _pair(x, dtype, k=10):
    """The JAX Index and the port's (CPU) over the same rows."""
    cfg = PipelineConfig(index=IndexConfig(dtype=dtype, row_tile=8),
                         search=SearchConfig(k=k))
    names = [f"im{i}" for i in range(len(x))]
    jidx = JaxIndex.from_descriptors(x, names, cfg)
    tidx = Index.from_descriptors(
        x, names, TorchPipelineConfig.from_json(cfg.to_json()), device="cpu")
    return jidx, tidx


def _assert_ids_agree(js, ji, ts, ti):
    """Equal ids, except at slots where JAX's own scores of the two ids lie
    within TOL; scores within TOL."""
    for q in range(ji.shape[0]):
        jscore = dict(zip(ji[q].tolist(), js[q].tolist()))
        for a, b in zip(ji[q], ti[q]):
            if a != b:
                assert b in jscore and abs(jscore[a] - jscore[b]) < TOL
    np.testing.assert_allclose(ts, js, rtol=0, atol=TOL)


@pytest.mark.parametrize("dtype", ["bfloat16", "int8", "int4"])
def test_odd_width_matches_jax_index(dtype):
    """D = 31: the store pads to the kernels' multiple, dim stays 31 (int4:
    32, the reference's dim with its zero column), and both routes rank as
    the reference does."""
    rng = np.random.default_rng(31)
    x, q = _unit(rng, 640, 31), _unit(rng, 6, 31)
    jidx, tidx = _pair(x, dtype)
    assert tidx.dim == jidx.dim
    assert tidx.store_dim % {"bfloat16": 8, "int8": 16, "int4": 32}[dtype] == 0
    js, ji = jidx.search(q)                         # the oracle on the CPU
    ts, ti = tidx.with_search(use_pallas=False).search(q)
    np.testing.assert_array_equal(ti, np.asarray(ji))
    np.testing.assert_allclose(ts, np.asarray(js), rtol=0, atol=TOL)

    # the kernel route: the port's plain version over the padded store
    # against the JAX kernel, in interpret mode, over the unpadded store
    jq = jidx._match_query_dim(jnp.asarray(q))
    kernel = functools.partial(getattr(jax_kernels, JAX_KERNELS[dtype]),
                               interpret=True)
    args = (() if dtype == "bfloat16" else (jidx.scales,))
    ks, kp = kernel(jidx.descriptors, *args, jq, k=10,
                    num_valid=jidx.num_valid, tile_n=128)
    tq = tidx._match_query_dim(torch.from_numpy(q))
    ps, pp = _topk_raw(tidx.descriptors, tidx.ids, tq, tidx.num_valid,
                       tidx.scales, k=10, use_kernel=True,
                       int4=tidx.is_int4)
    ks, kp = (torch.from_numpy(np.array(a)) for a in (ks, kp))
    if dtype == "bfloat16":
        check_against_plain(tidx.descriptors, tq, ps, pp, ks.float(), kp,
                            TOL)
    else:
        check_exact(ps, pp, ks, kp)


def test_k_past_k_max_takes_the_oracle(monkeypatch):
    """search(k=2000) on a 3,000-row store (bf16) returns the JAX Index's
    ranking, through the scoring oracle: the kernel is never called."""
    rng = np.random.default_rng(2000)
    x, q = _unit(rng, 3000, 64), _unit(rng, 4, 64)
    jidx, tidx = _pair(x, "bfloat16")
    calls = []
    monkeypatch.setattr(tindex, "topk_matmul",
                        lambda *a, **kw: calls.append(kw["k"]))
    scfg = tidx.cfg.search.replace(k=2000)
    ts, ti = tidx.search(q, scfg)
    assert calls == [] and tidx.cfg.search.use_pallas
    js, ji = jidx.search(q, jidx.cfg.search.replace(k=2000))
    assert ti.shape == (4, 2000) and (ti >= 0).all()
    _assert_ids_agree(np.asarray(js), np.asarray(ji), ts, ti)


def test_build_pq_with_m_12_ranks_as_the_unpadded_plain_version():
    """D = 96 gives M = 12 (``default_m``): six code bytes a row, padded to
    eight. The scan over the padded codes equals the plain version over the
    unpadded ones bit for bit, and the cascade searches."""
    rng = np.random.default_rng(96)
    x, q = _unit(rng, 1024, 96), _unit(rng, 5, 96)
    _, tidx = _pair(x, "float32")
    view = tidx.build_pq(iters=4, depth=64)
    assert view.m == 12 and tuple(view.packed.shape) == (1024, 8)
    assert tuple(view.codes.shape) == (1024, 6)
    assert not view.packed[:, 6:].any()
    tq = torch.from_numpy(q)
    for k in (1, 10, 64):
        s, i = pq_topk(view.packed, tq, view.codebook, k=k,
                       num_valid=tidx.num_valid)
        rs, ri = pq_topk_reference(view.codes.contiguous(), tq,
                                   view.codebook, k=k,
                                   num_valid=tidx.num_valid)
        check_exact(s, i, rs, ri)
    s, i = tidx.search(q)
    assert i.shape == (5, 10) and np.isfinite(s).all()
    np.testing.assert_array_equal(i[:, 0], np.argmax(q @ x.T, axis=1))


@pytest.mark.parametrize("dtype", ["bfloat16", "int8", "int4"])
@pytest.mark.parametrize("d", [31, 100, 299])
@pytest.mark.parametrize("k", [10, 2000])
def test_meta_stores_reach_the_cuda_check(dtype, d, k, monkeypatch):
    """A store on ``meta`` takes the kernel route (it is not on the CPU) and
    has no data: a width or depth the wrapper refused would raise its shape
    error before the CUDA-operand check. k past K_MAX takes the oracle,
    which runs on meta tensors."""
    rng = np.random.default_rng(d)
    cfg = TorchPipelineConfig(
        index=TorchPipelineConfig().index.replace(dtype=dtype))
    idx = Index.from_descriptors(_unit(rng, 300, d),
                                 [f"im{i}" for i in range(300)], cfg,
                                 device="meta")
    q = idx._match_query_dim(torch.zeros((3, d), device="meta"))
    oracle = []
    monkeypatch.setattr(tindex, "search_topk", functools.partial(
        lambda f, *a, **kw: oracle.append(1) or f(*a, **kw),
        tindex.search_topk))

    def run():
        return _topk_raw(idx.descriptors, idx.ids, q, idx.num_valid,
                         idx.scales, k=k, use_kernel=True, int4=idx.is_int4)

    if k > K_MAX:
        s, i = run()
        assert oracle and tuple(i.shape) == (3, k)
    else:
        with pytest.raises(ValueError, match="kernel takes CUDA tensors"):
            run()
        assert not oracle


@pytest.mark.parametrize("k", [10, K_MAX])
def test_meta_pq_view_with_m_12_reaches_the_cuda_check(k):
    cb = PQCodebook(torch.zeros((12, 16, 8), device="meta"))
    view = PQView(cb, torch.zeros((256, 6), dtype=torch.int8, device="meta"))
    assert tuple(view.packed.shape) == (256, 8)
    with pytest.raises(ValueError, match="kernel takes CUDA tensors"):
        pq_topk(view.packed, torch.zeros((2, 96), device="meta"), cb, k=k)
