"""Expert-parallel local whitening (``instsearch_torch/parallel/ep.py``)
against the single-device ``apply_local_whitening`` and against
``instsearch_tpu/parallel/ep.py`` on the eight virtual CPU devices of
tests/conftest.py, with one bank (the port's fit carried into JAX).

Tolerances: against the port's own single-device whitening EQUAL (each row
has one non-zero contributor, so the sum over shards is exact, and each
expert's product sees the same rows in the same order); against JAX 1e-6
(the same bank, f32 products in two orders).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from instsearch_tpu.ops.local_whiten import \
    LocalWhiteningParams as JaxParams
from instsearch_tpu.parallel import ep as jep
from instsearch_torch.ops.local_whiten import (apply_local_whitening,
                                               fit_local_whitening)
from instsearch_torch.parallel import expert_whiten_fn, make_mesh, place_ep

D, E = 24, 8


@pytest.fixture(scope="module")
def bank():
    rng = np.random.default_rng(21)
    centres = rng.standard_normal((E, D)).astype(np.float32)
    x = centres[rng.integers(0, E, 800)] + 0.5 * rng.standard_normal(
        (800, D)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    x = torch.as_tensor(x)
    return x, fit_local_whitening(x, E, dim=16, seed=0)


@pytest.mark.parametrize("shards", [1, 2, 4, 8])
def test_equals_the_single_device_whitening(bank, shards):
    x, params = bank
    mesh = make_mesh(shards, devices=["cpu"] * shards)
    got = expert_whiten_fn(mesh)(params, x[:300])
    assert torch.equal(got, apply_local_whitening(x[:300], params))
    raw = expert_whiten_fn(mesh, renormalize=False)(place_ep(mesh, params),
                                                    x[:300])
    assert torch.equal(raw, apply_local_whitening(x[:300], params,
                                                  renormalize=False))


@pytest.mark.parametrize("shards", [2, 4])
def test_matches_jax_expert_whiten_fn(bank, shards):
    x, params = bank
    jparams = JaxParams(*(jnp.asarray(t.numpy()) for t in params))
    jmesh = Mesh(np.array(jax.devices()[:shards]), ("expert",))
    want = jax.jit(jep.expert_whiten_fn(jmesh))(
        jep.place_ep(jmesh, jparams), jnp.asarray(x[:200].numpy()))
    mesh = make_mesh(shards, devices=["cpu"] * shards)
    got = expert_whiten_fn(mesh)(place_ep(mesh, params), x[:200])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_place_ep_splits_the_bank_and_replicates_the_router(bank):
    _, params = bank
    mesh = make_mesh(4, devices=["cpu"] * 4)
    placed = place_ep(mesh, params)
    assert len(placed.P) == len(placed.mu) == len(placed.centroids) == 4
    for j in range(4):
        assert torch.equal(placed.P[j], params.P[2 * j:2 * j + 2])
        assert torch.equal(placed.mu[j], params.mu[2 * j:2 * j + 2])
        assert torch.equal(placed.centroids[j], params.centroids)
    with pytest.raises(ValueError, match="not divisible"):
        place_ep(make_mesh(3, devices=["cpu"] * 3), params)
