"""αDBA, the database-side augmentation (``instsearch_torch/search/dba.py``,
``Index.augment_database``, ``qe.expand_from_candidates(include_query=
False)``), against ``instsearch_tpu``'s on the same seeded rows.

The rows are clusters of seeded unit rows (200 valid in a capacity of 256,
D = 32, whose stored width is the kernels' multiple in every dtype), with
no near-tie at any row's 5th neighbour, so both packages pick the same
neighbour sets.

Tolerances: the weighting and the oracle 1e-6 (f32 sums in two orders);
the augmented stores, quantized from f32 buffers that agree within 1e-6:
int8/int4 row scales within 1e-6 relative and each component within one
quantization step (a value may round to the neighbouring integer where
the two buffers straddle a rounding point), bf16 within one bf16 step. The kernel route (K1-K3's plain
versions) is held to the reference's ``_dba_chunk_jit(use_pallas=True)``
with the Pallas kernels in interpret mode.
"""
import functools
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import instsearch_tpu.kernels as jax_kernels
from instsearch_tpu.config import IndexConfig as JaxIndexConfig
from instsearch_tpu.config import PipelineConfig as JaxPipelineConfig
from instsearch_tpu.config import SearchConfig as JaxSearchConfig
from instsearch_tpu.index import Index as JaxIndex
from instsearch_tpu.index import _dba_chunk_jit
from instsearch_tpu.search import dba as jdba
from instsearch_tpu.search import qe as jqe
from instsearch_torch import PipelineConfig
from instsearch_torch.index import Index, attach_regional_store
from instsearch_torch.search import dba as tdba
from instsearch_torch.search import qe as tqe

N, CAP, D, NN = 200, 256, 32, 5
JAX_KERNELS = {"bfloat16": "topk_matmul", "int8": "topk_matmul_int8",
               "int4": "topk_matmul_int4"}


def _rows(seed=3):
    rng = np.random.default_rng(seed)
    centres = rng.standard_normal((20, D)).astype(np.float32)
    x = (centres[rng.integers(0, 20, N)]
         + 0.7 * rng.standard_normal((N, D)).astype(np.float32))
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _pair(dtype, refine=False, **index):
    """The JAX Index and the port's over the same rows, both on the oracle
    route (the port's kernel route is its own config's ``use_pallas``)."""
    x = _rows()
    cfg = JaxPipelineConfig(
        index=JaxIndexConfig(dtype=dtype, row_tile=64, capacity=CAP,
                             dba_n=NN, refine_dtype="int8" if refine else "",
                             **index),
        search=JaxSearchConfig(k=8, use_pallas=False))
    names = [f"r{i}" for i in range(N)]
    jidx = JaxIndex.from_descriptors(x, names, cfg)
    tidx = Index.from_descriptors(x, names,
                                  PipelineConfig.from_json(cfg.to_json()),
                                  device="cpu")
    return x, jidx, tidx


def _rows_f32(idx, n=CAP):
    return np.asarray(idx._rows_f32_chunk(0, n))


def test_fixture_has_no_near_tie_at_the_nth_neighbour():
    x = _rows()
    s = np.sort(x @ x.T, axis=1)[:, ::-1]
    assert (s[:, NN - 1] - s[:, NN]).min() > 1e-5


@pytest.mark.parametrize("include_query", [True, False])
def test_expand_from_candidates_matches_jax(include_query):
    rng = np.random.default_rng(0)
    q = rng.standard_normal((4, D)).astype(np.float32)
    s = rng.uniform(-0.2, 1.0, (4, 6)).astype(np.float32)
    s[3, 4:] = -np.inf
    nb = rng.standard_normal((4, 6, D)).astype(np.float32)
    nb[3, 4:] = 0.0
    want = jqe.expand_from_candidates(jnp.asarray(q), jnp.asarray(s),
                                      jnp.asarray(nb), 3.0,
                                      include_query=include_query)
    got = tqe.expand_from_candidates(torch.as_tensor(q), torch.as_tensor(s),
                                     torch.as_tensor(nb), 3.0,
                                     include_query=include_query)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_dba_augment_oracle_matches_jax(dtype):
    _, jidx, tidx = _pair(dtype)
    jsc = None if jidx.scales is None else jidx.scales
    want = jdba.dba_augment(jidx.descriptors, jidx.ids, n=NN, scales=jsc)
    got = tdba.dba_augment(tidx.descriptors, tidx.ids, n=NN,
                           scales=tidx.scales)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    assert bool((got[N:] == 0).all())


def _assert_stores(jidx, tidx, dtype):
    if dtype in ("int8", "int4"):
        sj = np.asarray(jidx.scales)
        np.testing.assert_allclose(tidx.scales.numpy(), sj, rtol=1e-6)
        # a component may round to the neighbouring integer where the two
        # f32 buffers straddle a rounding point: one step (its row scale)
        step = sj.reshape(-1, 1) * 1.0001 + 1e-9
        assert (np.abs(_rows_f32(tidx) - _rows_f32(jidx)) < step).all()
    else:
        a, b = _rows_f32(tidx), _rows_f32(jidx)
        np.testing.assert_array_less(np.abs(a - b),
                                     np.abs(b) * 2.0 ** -7 + 1e-7)


@pytest.mark.parametrize("chunk", [None, 48])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "int8", "int4"])
def test_augment_database_oracle_route_matches_jax(dtype, chunk):
    """``chunk=48``: the last chunk slides back to ``N_pad - chunk``."""
    _, jidx, tidx = _pair(dtype)
    assert not tidx.cfg.search.use_pallas
    jidx.augment_database(chunk=chunk)
    tidx.augment_database(chunk=chunk)
    _assert_stores(jidx, tidx, dtype)


@pytest.mark.parametrize("dtype", ["bfloat16", "int8", "int4"])
def test_augment_database_kernel_route_matches_jax_kernels(dtype,
                                                           monkeypatch):
    """The port's kernel route (K1-K3's plain versions on a CPU store) and
    the reference's ``_dba_chunk_jit`` on its kernel route, the Pallas
    kernel of the store's kind in interpret mode, chunk by chunk into one
    f32 buffer, then quantized as ``augment_database`` does."""
    _, jidx, tidx = _pair(dtype)
    name = JAX_KERNELS[dtype]
    monkeypatch.setattr(jax_kernels, name, functools.partial(
        getattr(jax_kernels, name), interpret=True))
    tidx.cfg = tidx.cfg.replace(search=tidx.cfg.search.replace(
        use_pallas=True))
    buf = np.zeros((CAP, D), np.float32)
    for start in range(0, N, 128):
        s0 = min(start, CAP - 128)
        buf[s0:s0 + 128] = np.asarray(_dba_chunk_jit(
            jidx.descriptors, jidx.ids, jnp.asarray(N, jnp.int32),
            jidx.scales, jnp.asarray(s0, jnp.int32), n=NN, alpha=3.0,
            use_pallas=True, chunk=128, int4=jidx.is_int4))
    tidx.augment_database()
    if dtype == "bfloat16":
        np.testing.assert_array_less(np.abs(_rows_f32(tidx) - buf),
                                     np.abs(buf) * 2.0 ** -8 + 1e-7)
        return
    from instsearch_tpu.ops import quantize as jq
    qr = (jq.quantize_rows_int4 if dtype == "int4"
          else jq.quantize_rows)(jnp.asarray(buf))
    jidx.descriptors, jidx.scales = qr.values, qr.scales
    _assert_stores(jidx, tidx, dtype)


def test_refine_store_is_rederived_from_the_buffer():
    """int4 with the int8 refine copy: both re-quantized from the one f32
    buffer, as the reference; refine search answers as JAX's."""
    x, jidx, tidx = _pair("int4", refine=True)
    jidx.augment_database()
    tidx.augment_database()
    _assert_stores(jidx, tidx, "int4")
    rs = np.asarray(jidx.regional_scales)
    np.testing.assert_allclose(tidx.regional_scales.numpy(), rs, rtol=1e-6)
    assert np.abs(tidx.regional.numpy().astype(int)
                  - np.asarray(jidx.regional).astype(int)).max() <= 1
    scfg = jidx.cfg.search.replace(refine_enabled=True, rerank_depth=20)
    js, ji = jidx.search(x[:4], scfg)
    ts, ti = tidx.search(x[:4], PipelineConfig.from_json(
        jidx.cfg.replace(search=scfg).to_json()).search)
    np.testing.assert_array_equal(ti, np.asarray(ji))
    np.testing.assert_allclose(ts, np.asarray(js), atol=1e-6)


def test_regional_store_keeps_its_raw_rows():
    x, _, tidx = _pair("bfloat16")
    reg = np.repeat(x[:, None, :], 3, axis=1)
    attach_regional_store(tidx, reg)
    before = tidx.regional.clone()
    tidx.augment_database()
    assert torch.equal(tidx.regional, before)


def test_views_are_dropped_with_a_warning(caplog):
    x, jidx, tidx = _pair("int4")
    tidx.build_pq(m=4, iters=2, depth=20)
    tidx.fit_local_whitening(n_clusters=4)
    assert tidx.cfg.search.lw_enabled
    with caplog.at_level(logging.WARNING, logger="instsearch.index"):
        tidx.augment_database()
    assert tidx.pq is None and tidx.lw is None
    assert not tidx.cfg.search.lw_enabled
    text = caplog.text
    assert "PQ view invalidated by augment_database()" in text
    assert "local-whitening view invalidated by augment_database()" in text
    jidx.augment_database()
    _assert_stores(jidx, tidx, "int4")


def test_defaults_come_from_the_config():
    """``n``/``alpha`` default to ``dba_n``/``dba_alpha``; an empty index
    is left alone."""
    _, jidx, tidx = _pair("float32", dba_alpha=1.0)
    jidx.augment_database()
    tidx.augment_database()
    _assert_stores(jidx, tidx, "float32")
    empty = Index.from_descriptors(np.zeros((0, D), np.float32), [],
                                   tidx.cfg, device="cpu")
    empty.augment_database()
    assert empty.num_valid == 0
