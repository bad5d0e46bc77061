"""Local-whitening re-ranking (``instsearch_torch/search/lw_rerank.py`` and
the ``lw_enabled`` stage of ``Index.search``) against ``instsearch_tpu``'s
on the same seeded rows.

The store: 400 rows around 4 anisotropic clusters in a capacity of 448
(row tile 64, D = 32), so every cluster has more members than D and the
global covariance each blends toward has full rank.

Two kinds of comparison, since each package's bank carries its own
eigenvector signs (test_torch_local_whiten.py):
  * through the REFERENCE's bank (its view's centroids, P, mu, store and
    assignments carried into the port): the query whitening, the re-score
    and the whole composite within 1e-6 (f32 sums in two orders), ids
    equal; the port's whitened store from that bank within one bf16 step of
    the reference's; absorbed adds and removes likewise;
  * each package's own fit: routing equal, scores within 2e-3 (the bf16
    store holds each whitened component to one bf16 step, 2^-8 of it, and
    the two banks differ in the last f32 bits, which move a component
    across a rounding point), ids equal but at near-ties under that bar.
Persistence: an index with a view saved by either package loads in the
other with equal stores and the same answers.
"""
import functools
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import instsearch_tpu.kernels as jax_kernels
from instsearch_tpu.config import IndexConfig as JaxIndexConfig
from instsearch_tpu.config import PipelineConfig as JaxPipelineConfig
from instsearch_tpu.config import SearchConfig as JaxSearchConfig
from instsearch_tpu.index import Index as JaxIndex
from instsearch_tpu.index import _lw_composite_jit
from instsearch_tpu.search import lw_rerank as jlw
from instsearch_torch import PipelineConfig
from instsearch_torch.index import Index
from instsearch_torch.ops.local_whiten import LocalWhiteningParams
from instsearch_torch.search import lw_rerank as tlw

N, CAP, D, E = 400, 448, 32, 4
TOL = 1e-6
OWN_TOL = 2e-3
JAX_KERNELS = {"bfloat16": "topk_matmul", "int8": "topk_matmul_int8",
               "int4": "topk_matmul_int4"}


def _rows(seed=5):
    rng = np.random.default_rng(seed)
    centres = rng.standard_normal((E, D)).astype(np.float32)
    centres /= np.linalg.norm(centres, axis=1, keepdims=True)
    scale = np.linspace(0.15, 0.5, D).astype(np.float32)
    x = (centres[rng.integers(0, E, N + 40)]
         + scale * rng.standard_normal((N + 40, D)).astype(np.float32))
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _pair(dtype="bfloat16", use_pallas=False, fit=True):
    x = _rows()
    cfg = JaxPipelineConfig(
        index=JaxIndexConfig(dtype=dtype, row_tile=64, capacity=CAP),
        search=JaxSearchConfig(k=8, rerank_depth=30, qe_enabled=True,
                               qe_n=4, use_pallas=use_pallas))
    names = [f"r{i}" for i in range(N)]
    jidx = JaxIndex.from_descriptors(x[:N], names, cfg)
    tidx = Index.from_descriptors(x[:N], names,
                                  PipelineConfig.from_json(cfg.to_json()),
                                  device="cpu")
    if fit:
        jidx.fit_local_whitening(n_clusters=E)
    return x, jidx, tidx


def _carry(jview):
    """The reference's view as the port's (the same bank and store)."""
    p = jview.params
    params = LocalWhiteningParams(*(torch.tensor(np.asarray(t))
                                    for t in (p.centroids, p.P, p.mu)))
    return tlw.LocalWhiteningView(
        params, torch.tensor(np.asarray(jview.store.astype(jnp.float32)))
        .to(torch.bfloat16), torch.tensor(np.asarray(jview.assign)))


def _port_search(jidx, scfg):
    return PipelineConfig.from_json(jidx.cfg.replace(search=scfg)
                                    .to_json()).search


def _assert_ranked(js, ji, ts, ti, tol):
    js, ji = np.asarray(js), np.asarray(ji)
    np.testing.assert_array_equal(np.isfinite(ts), np.isfinite(js))
    fin = np.isfinite(js)
    np.testing.assert_allclose(ts[fin], js[fin], rtol=0, atol=tol)
    for r in range(ji.shape[0]):
        score = dict(zip(ji[r].tolist(), js[r].tolist()))
        for a, b in zip(ti[r].tolist(), ji[r].tolist()):
            if a != b:
                assert a in score and abs(score[a] - score[b]) < tol, (r, a, b)


def _queries(x):
    return x[N:N + 6]


def test_whiten_all_clusters_and_rescore_match_jax():
    x, jidx, _ = _pair()
    v = jidx.lw
    q = _queries(x)
    want = jlw.whiten_all_clusters(jnp.asarray(q), v.params.P, v.params.mu)
    tv = _carry(v)
    got = tlw.whiten_all_clusters(torch.as_tensor(q), tv.params.P,
                                  tv.params.mu)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)
    rng = np.random.default_rng(0)
    pos = rng.integers(0, N, (6, 30)).astype(np.int32)
    pos[5, 20:] = -1
    cs = np.where(pos >= 0, 0.5, -np.inf).astype(np.float32)
    js, ji = jlw.lw_rescore_from_candidates(
        v.store, v.assign, jidx.ids, jnp.asarray(cs), jnp.asarray(pos),
        want, k=12)
    ts, ti = tlw.lw_rescore_from_candidates(
        tv.store, tv.assign, torch.as_tensor(np.asarray(jidx.ids)),
        torch.as_tensor(cs), torch.as_tensor(pos), got, k=12)
    _assert_ranked(js, ji, ts.numpy(), ti.numpy(), TOL)


def test_view_store_from_the_reference_bank():
    """``apply_local_whitening`` and ``route`` of the port under the
    reference's bank give the reference's store (one bf16 step) and
    assignments (equal)."""
    from instsearch_torch.ops.local_whiten import (apply_local_whitening,
                                                   route)
    _, jidx, tidx = _pair()
    tv = _carry(jidx.lw)
    rows = tidx._rows_f32_chunk(0, N)            # the stored bf16 rows
    store = apply_local_whitening(rows, tv.params)
    want = tv.store[:N].float()
    assert bool(((store - want).abs() <= want.abs() * 2.0 ** -7
                 + 1e-7).all())
    np.testing.assert_array_equal(route(rows, tv.params).numpy(),
                                  np.asarray(jidx.lw.assign)[:N])


@pytest.mark.parametrize("dtype", ["bfloat16", "int8", "int4"])
def test_composite_through_the_reference_bank(dtype):
    x, jidx, tidx = _pair(dtype)
    tidx.lw = _carry(jidx.lw)
    q = _queries(x)
    for subset in (None, list(range(0, N, 2))):
        js, ji = jidx.search(q, subset=subset)
        ts, ti = tidx.search(q, _port_search(jidx, jidx.cfg.search),
                             subset=subset)
        _assert_ranked(js, ji, ts, ti, TOL)


@pytest.mark.parametrize("dtype", ["bfloat16", "int8", "int4"])
def test_kernel_route_matches_jax_kernels(dtype, monkeypatch):
    x, jidx, tidx = _pair(dtype, use_pallas=True)
    tidx.lw = _carry(jidx.lw)
    name = JAX_KERNELS[dtype]
    monkeypatch.setattr(jax_kernels, name, functools.partial(
        getattr(jax_kernels, name), interpret=True))
    q = _queries(x)
    v, scfg = jidx.lw, jidx.cfg.search
    js, ji = _lw_composite_jit(
        jidx.descriptors, jidx.ids, jidx._match_query_dim(jnp.asarray(q)),
        jnp.asarray(N, jnp.int32), jidx.scales, v.params.P, v.params.mu,
        v.store, v.assign, k=scfg.k, depth=scfg.rerank_depth,
        qe_n=scfg.qe_n, qe_alpha=scfg.qe_alpha, use_pallas=True, do_qe=True,
        int4=jidx.is_int4)
    ts, ti = tidx.search(q, _port_search(jidx, scfg))
    _assert_ranked(js, ji, ts, ti, TOL)


def test_own_fit_matches_jax_through_search():
    """``Index.fit_local_whitening`` of each package: the same k-means (the
    same seeded draws), routing equal, answers within OWN_TOL."""
    x, jidx, tidx = _pair()
    view = tidx.fit_local_whitening(n_clusters=E)
    assert tidx.cfg.search.lw_enabled and view is tidx.lw
    np.testing.assert_array_equal(view.assign.numpy(),
                                  np.asarray(jidx.lw.assign))
    q = _queries(x)
    js, ji = jidx.search(q)
    ts, ti = tidx.search(q)
    _assert_ranked(js, ji, ts, ti, OWN_TOL)


def test_default_size_is_sqrt_n_as_a_power_of_two():
    _, jidx, tidx = _pair(fit=False)
    assert tidx.fit_local_whitening().n_clusters == \
        jidx.fit_local_whitening().n_clusters == 16


def test_lw_enabled_without_a_view_raises():
    x, _, tidx = _pair(fit=False)
    with pytest.raises(ValueError, match="fit_local_whitening"):
        tidx.search(x[:2], tidx.cfg.search.replace(lw_enabled=True))


@pytest.mark.parametrize("grow", [False, True], ids=["in_place", "re_pad"])
def test_absorb_add_and_remove_match_jax(grow):
    """The same add (in place, or past capacity: the view grows) and the
    same remove on both, the port's view carried from the reference's:
    stores within one bf16 step, assignments equal, answers as JAX's."""
    x, jidx, tidx = _pair()
    tidx.lw = _carry(jidx.lw)
    n_add = 60 if grow else 20
    rng = np.random.default_rng(9)
    new = x[N:N + 40][rng.integers(0, 40, n_add)] + 0.01 * \
        rng.standard_normal((n_add, D)).astype(np.float32)
    new /= np.linalg.norm(new, axis=1, keepdims=True)
    names = [f"n{i}" for i in range(n_add)]
    jidx.add(descriptors=new, names=names)
    tidx.add(descriptors=new, names=names)
    assert tidx.lw.store.shape[0] == tidx.descriptors.shape[0] == \
        jidx.lw.store.shape[0]
    gone = ["r3", "r17", "n1", "r250"]
    jidx.remove(gone)
    tidx.remove(gone)
    nv = tidx.num_valid
    want = np.asarray(jidx.lw.store.astype(jnp.float32))[:nv]
    got = tidx.lw.store[:nv].float().numpy()
    assert (np.abs(got - want) <= np.abs(want) * 2.0 ** -7 + 1e-7).all()
    np.testing.assert_array_equal(tidx.lw.assign[:nv].numpy(),
                                  np.asarray(jidx.lw.assign)[:nv])
    q = np.concatenate([_queries(x), new[:2]])
    js, ji = jidx.search(q)
    ts, ti = tidx.search(q, _port_search(jidx, jidx.cfg.search))
    _assert_ranked(js, ji, ts, ti, 1e-5)


def test_lw_saved_by_jax_loads_in_the_port(tmp_path):
    x, jidx, _ = _pair("int8")
    jidx.save(str(tmp_path), streaming=False)
    with open(tmp_path / "lw" / "lw.json") as f:
        assert json.load(f) == {"n_clusters": E, "dim": D}
    tidx = Index.load(str(tmp_path), device="cpu")
    assert tidx.cfg.search.lw_enabled
    np.testing.assert_array_equal(
        tidx.lw.store.float().numpy(),
        np.asarray(jidx.lw.store.astype(jnp.float32)))
    q = _queries(x)
    _assert_ranked(*jidx.search(q), *tidx.search(q), TOL)


def test_lw_saved_by_the_port_loads_in_jax(tmp_path):
    x, _, tidx = _pair("int4", fit=False)
    tidx.fit_local_whitening(n_clusters=E)
    tidx.save(str(tmp_path))
    assert sorted(os.listdir(tmp_path / "lw")) == ["lw.json", "lw.npz"]
    jidx = JaxIndex.load(str(tmp_path))
    np.testing.assert_array_equal(np.asarray(jidx.lw.params.P),
                                  tidx.lw.params.P.numpy())
    q = _queries(x)
    _assert_ranked(*jidx.search(q), *tidx.search(q), TOL)
    again = Index.load(str(tmp_path), device="cpu")
    for a, b in zip(again.search(q), tidx.search(q)):
        np.testing.assert_array_equal(a, b)
