"""Diffusion re-ranking (``instsearch_torch/search/diffusion.py`` and the
diffusion stage of ``Index.search``) against ``instsearch_tpu``'s on the
same seeded numpy inputs.

Tolerances:
  * the affinity ``W``: 1e-6 (f32 products of unit rows in two orders);
  * diffused scores ``f``: 1e-5 of the row's largest |f|. ``f`` solves
    ``(I - alpha W) f = y`` by 20 CG steps; at alpha = 0.99 the system's
    condition number reaches ~200, so the two libraries' f32 orders
    (measured ~3e-6 of the largest) are amplified past an absolute bar;
  * ranked ids equal, except where the reference's own scores of the two
    ids are within that bar (a near-tie the f32 order may flip);
  * the composite through the Index (diffusion after αQE, with a subset)
    by the same rule, on the oracle route against the JAX Index and on the
    kernel route (K1-K3's plain versions) against
    ``_search_composite_jit(use_pallas=True, do_diffusion=True)`` with the
    Pallas kernels in interpret mode.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import instsearch_tpu.kernels as jax_kernels
from instsearch_tpu.config import IndexConfig as JaxIndexConfig
from instsearch_tpu.config import PipelineConfig as JaxPipelineConfig
from instsearch_tpu.config import SearchConfig as JaxSearchConfig
from instsearch_tpu.index import Index as JaxIndex
from instsearch_tpu.index import _search_composite_jit
from instsearch_tpu.search import diffusion as jd
from instsearch_torch import PipelineConfig
from instsearch_torch.index import Index
from instsearch_torch.search import diffusion as td

REL = 1e-5
JAX_KERNELS = {"bfloat16": "topk_matmul", "int8": "topk_matmul_int8",
               "int4": "topk_matmul_int4"}


def _unit(rng, *shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _candidates(seed=0, q=3, l=40, d=24, invalid=8):
    """Candidate rows around a few centres (so the graph has structure)
    and sorted global scores, the last ``invalid`` slots of the last query
    empty."""
    rng = np.random.default_rng(seed)
    centres = _unit(rng, 4, d)
    cand = centres[rng.integers(0, 4, (q, l))] + 0.6 * _unit(rng, q, l, d)
    cand /= np.linalg.norm(cand, axis=-1, keepdims=True)
    g = np.sort(rng.uniform(0.1, 0.95, (q, l)).astype(np.float32),
                axis=1)[:, ::-1].copy()
    if invalid:
        g[-1, -invalid:] = -np.inf
    return cand, g


def _assert_scores(want, got, rel=REL):
    want, got = np.asarray(want), np.asarray(got)
    fin = np.isfinite(want)
    np.testing.assert_array_equal(fin, np.isfinite(got))
    scale = max(1.0, float(np.abs(want[fin]).max()))
    np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=rel * scale)
    return rel * scale


def _assert_ranked(js, ji, ts, ti, tol):
    """Ids equal but at near-ties of the reference's scores."""
    js, ji = np.asarray(js), np.asarray(ji)
    np.testing.assert_array_equal(ji >= 0, ti >= 0)
    for r in range(ji.shape[0]):
        score = dict(zip(ji[r].tolist(), js[r].tolist()))
        for a, b in zip(ti[r].tolist(), ji[r].tolist()):
            if a != b:
                assert a in score and abs(score[a] - score[b]) < tol, (r, a, b)


@pytest.mark.parametrize("knn", [3, 10])
def test_affinity_matches_jax(knn):
    cand, g = _candidates()
    valid = np.isfinite(g)
    want = jd._mutual_knn_affinity(jnp.asarray(cand), jnp.asarray(valid), knn)
    got = td.mutual_knn_affinity(torch.as_tensor(cand),
                                 torch.as_tensor(valid), knn)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    # symmetric up to the order of the two degree scalings
    torch.testing.assert_close(got, got.transpose(1, 2), rtol=0, atol=1e-7)


@pytest.mark.parametrize("alpha", [0.5, 0.99])
def test_cg_solve_matches_jax(alpha):
    cand, g = _candidates(invalid=0)
    w = td.mutual_knn_affinity(torch.as_tensor(cand),
                               torch.ones(g.shape, dtype=torch.bool), 10)
    y = np.clip(g, 0, None) ** 3
    want = jd._cg_solve(jnp.asarray(w.numpy()), jnp.asarray(y), alpha, 20)
    got = td.cg_solve(w, torch.as_tensor(y), alpha, 20)
    _assert_scores(want, got.numpy())
    # twenty steps at alpha = 0.5 solve the system
    if alpha == 0.5:
        a = np.eye(y.shape[1]) - alpha * w.numpy()
        np.testing.assert_allclose(np.einsum("qlm,qm->ql", a, got.numpy()),
                                   y, atol=1e-4)


@pytest.mark.parametrize("seeds,knn", [(10, 10), (3, 5), (60, 10)])
def test_diffuse_from_candidates_matches_jax(seeds, knn):
    cand, g = _candidates(seed=seeds)
    want = jd.diffuse_from_candidates(jnp.asarray(cand), jnp.asarray(g),
                                      knn=knn, seeds=seeds)
    got = td.diffuse_from_candidates(torch.as_tensor(cand),
                                     torch.as_tensor(g), knn=knn, seeds=seeds)
    _assert_scores(want, got.numpy())


@pytest.mark.parametrize("k", [5, 40, 50])
def test_rerank_from_candidates_matches_jax(k):
    """Past the candidates (k = 50 > L = 40) the slots are (-inf, -1)."""
    cand, g = _candidates()
    pos = np.tile(np.arange(40, dtype=np.int32) * 3, (3, 1))
    pos[np.isinf(g)] = -1
    ids = np.arange(130, dtype=np.int32) + 1000
    js, ji = jd.diffusion_rerank_from_candidates(
        jnp.asarray(ids), jnp.asarray(g), jnp.asarray(pos),
        jnp.asarray(cand), k=k)
    ts, ti = td.diffusion_rerank_from_candidates(
        torch.as_tensor(ids), torch.as_tensor(g), torch.as_tensor(pos),
        torch.as_tensor(cand), k=k)
    tol = _assert_scores(js, ts.numpy())
    _assert_ranked(js, ji, ts.numpy(), ti.numpy(), tol)
    assert (ti.numpy()[:, 40:] == -1).all()


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_oracle_matches_jax(dtype):
    rng = np.random.default_rng(1)
    x = _unit(rng, 96, 24)
    ids = np.where(np.arange(96) < 90, np.arange(96), -1).astype(np.int32)
    q = x[:4] + 0.1 * _unit(rng, 4, 24)
    if dtype == "int8":
        from instsearch_tpu.ops.quantize import quantize_rows
        qr = quantize_rows(jnp.asarray(x))
        store, scales = np.asarray(qr.values), np.asarray(qr.scales)
        xf = store.astype(np.float32) * scales.reshape(-1, 1)
    else:
        store, scales, xf = x, None, x
    glob = np.where(ids[None] >= 0, q @ xf.T, -np.inf).astype(np.float32)
    js, ji = jd.diffusion_rerank_scores(
        jnp.asarray(store), jnp.asarray(ids), jnp.asarray(glob), depth=30,
        k=8, scales=None if scales is None else jnp.asarray(scales))
    ts, ti = td.diffusion_rerank_scores(
        torch.as_tensor(store), torch.as_tensor(ids), torch.as_tensor(glob),
        depth=30, k=8, scales=None if scales is None
        else torch.as_tensor(scales))
    tol = _assert_scores(js, ts.numpy())
    _assert_ranked(js, ji, ts.numpy(), ti.numpy(), tol)


# ---------------------------------------------------------------------------
# the diffusion stage of the Index composite

N, D = 200, 32
MEMBERS = list(range(0, N, 2))


def _pair(dtype, **search):
    """The JAX Index and the port's over the same seeded rows: clusters of
    rows around 12 centres, 200 rows in a capacity of 256."""
    rng = np.random.default_rng(7)
    centres = _unit(rng, 12, D)
    x = centres[rng.integers(0, 12, N)] + 0.5 * _unit(rng, N, D)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    cfg = JaxPipelineConfig(
        index=JaxIndexConfig(dtype=dtype, row_tile=64, capacity=256),
        search=JaxSearchConfig(k=10, diffusion_enabled=True,
                               diffusion_depth=60, qe_n=4, **search))
    names = [f"r{i}" for i in range(N)]
    jidx = JaxIndex.from_descriptors(x, names, cfg)
    tidx = Index.from_descriptors(x, names,
                                  PipelineConfig.from_json(cfg.to_json()),
                                  device="cpu")
    q = x[:5] + 0.2 * _unit(rng, 5, D)
    return jidx, tidx, q / np.linalg.norm(q, axis=1, keepdims=True)


@pytest.mark.parametrize("qe", [False, True], ids=["plain", "qe"])
@pytest.mark.parametrize("dtype", ["bfloat16", "int8", "int4"])
def test_composite_oracle_route_matches_jax_index(dtype, qe):
    jidx, tidx, q = _pair(dtype, qe_enabled=qe)
    for subset in (None, MEMBERS):
        js, ji = jidx.search(q, subset=subset)
        ts, ti = tidx.with_search(use_pallas=False).search(q, subset=subset)
        tol = _assert_scores(js, ts)
        _assert_ranked(js, ji, ts, ti, tol)
        if subset is not None:
            assert set(ti[ti >= 0].tolist()) <= set(MEMBERS)


@pytest.mark.parametrize("dtype", ["bfloat16", "int8", "int4"])
def test_composite_kernel_route_matches_jax_kernels(dtype, monkeypatch):
    jidx, tidx, q = _pair(dtype, qe_enabled=True)
    name = JAX_KERNELS[dtype]
    monkeypatch.setattr(jax_kernels, name, functools.partial(
        getattr(jax_kernels, name), interpret=True))
    scfg = jidx.cfg.search
    mask = jidx.make_subset(ids=MEMBERS).mask
    js, ji = _search_composite_jit(
        jidx.descriptors, jidx.ids, jidx._match_query_dim(jnp.asarray(q)),
        jnp.asarray(jidx.num_valid, jnp.int32), jidx.scales, None, None,
        None, None, mask, k=scfg.k, depth=scfg.diffusion_depth,
        qe_n=scfg.qe_n, qe_alpha=scfg.qe_alpha, use_pallas=True, do_qe=True,
        do_rerank=False, do_diffusion=True, int4=jidx.is_int4)
    ts, ti = tidx.search(q, subset=MEMBERS)
    tol = _assert_scores(js, ts)
    _assert_ranked(js, ji, ts, ti, tol)


def test_diffusion_keeps_the_exact_scan_under_pq():
    """With a PQ view armed, diffusion still takes the exact top-depth
    (the reference's routing): the answer equals the index without it."""
    _, tidx, q = _pair("int4", qe_enabled=True)
    want = tidx.search(q)
    tidx.build_pq(m=4, iters=3, depth=20)
    assert tidx.cfg.search.pq_depth == 20
    got = tidx.search(q)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a, b)
    tidx.search(q, tidx.cfg.search.replace(diffusion_enabled=False))
