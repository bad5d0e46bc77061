"""R-MAC pooling and regional whitening of the port (instsearch_torch.ops)
against the JAX functions on the same numpy-seeded inputs.

Tolerances: the region grid and its geometry are host integer and f32 math,
equal. Per-region MAC is a max, equal in f32 and bf16. ``rmac_pool`` in f32
within 1e-6 (the norms' sums in other orders); in bf16 each component
within one bf16 step of the JAX value (at most 2^-7 of its magnitude: the
two sides' f32 sums over the regions may round to neighbouring bf16 values;
measured: all equal). ``apply_whitening_regional`` within 1e-5 of JAX's (an f32 product
of width 64, then a re-L2), and the chunked path equal to one chunk.
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instsearch_tpu.ops import pooling as jpool
from instsearch_tpu.ops.whitening import WhiteningParams as JaxWhitening
from instsearch_tpu.ops.whitening import \
    apply_whitening_regional as jax_whiten_regional
from instsearch_torch.ops import pooling as tpool
from instsearch_torch.ops.whitening import (WhiteningParams,
                                            apply_whitening_regional)

SHAPES = [(1, 1), (2, 3), (7, 7), (13, 17), (32, 32), (32, 24), (31, 40)]


@pytest.mark.parametrize("levels", [1, 2, 3, 4])
def test_region_grid_equals_jax(levels):
    for h, w in itertools.product(range(1, 41), range(1, 41)):
        want = jpool.rmac_region_grid(h, w, levels)
        assert tpool.rmac_region_grid(h, w, levels) == want, (h, w)
        np.testing.assert_array_equal(
            tpool.rmac_region_geometry(h, w, levels),
            jpool.rmac_region_geometry(h, w, levels))


def test_region_count_at_the_presets_map():
    """512 px through VGG16 is a 32 x 32 map: 1 + 4 + 9 = 14 regions."""
    assert len(tpool.rmac_region_grid(32, 32, 3)) == 14
    assert tpool.rmac_region_geometry(32, 32, 3).shape == (14, 3)


def _fmap(h, w, c=48, n=3, seed=0):
    rng = np.random.default_rng(seed)
    return np.maximum(rng.standard_normal((n, h, w, c)), 0).astype(
        np.float32)


@pytest.mark.parametrize("h,w", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_regional_mac_equals_jax(h, w, dtype):
    x = _fmap(h, w)
    want = np.asarray(jpool.rmac_regional_descriptors(
        jnp.asarray(x, getattr(jnp, dtype)), 3).astype(jnp.float32))
    got = tpool.rmac_regional_descriptors(
        torch.from_numpy(x).to(getattr(torch, dtype)), 3)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("h,w", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmac_pool_matches_jax(h, w, dtype):
    x = _fmap(h, w, seed=1)
    want = np.asarray(jpool.rmac_pool(jnp.asarray(x, getattr(jnp, dtype)))
                      .astype(jnp.float32))
    got = tpool.rmac_pool(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    else:
        assert (np.abs(got - want) <= 2 ** -7 * np.abs(want)).all()


def test_pool_dispatches_rmac_with_its_levels():
    from instsearch_torch import ExtractConfig
    x = torch.from_numpy(_fmap(9, 12, seed=2))
    for levels in (1, 3):
        cfg = ExtractConfig(pooling="rmac", rmac_levels=levels)
        torch.testing.assert_close(tpool.pool(x, cfg),
                                   tpool.rmac_pool(x, levels), rtol=0,
                                   atol=0)


def _whitening(d_in=64, d_out=24, seed=3):
    rng = np.random.default_rng(seed)
    P = (rng.standard_normal((d_out, d_in)) / np.sqrt(d_in)).astype(
        np.float32)
    mu = (0.01 * rng.standard_normal(d_in)).astype(np.float32)
    return P, mu


@pytest.mark.parametrize("chunk", [7, 64, 65536])
def test_whitening_regional_matches_jax(chunk):
    P, mu = _whitening()
    rng = np.random.default_rng(4)
    reg = rng.standard_normal((37, 5, 64)).astype(np.float32)
    want = jax_whiten_regional(reg, JaxWhitening(jnp.asarray(P),
                                                 jnp.asarray(mu)), chunk=chunk)
    params = WhiteningParams(torch.from_numpy(P), torch.from_numpy(mu))
    got = apply_whitening_regional(reg, params, chunk=chunk)
    assert got.dtype == torch.float32 and tuple(got.shape) == (37, 5, 24)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    # a tensor in takes the same path, and one chunk equals many
    whole = apply_whitening_regional(torch.from_numpy(reg), params,
                                     chunk=1 << 20)
    torch.testing.assert_close(got, whole, rtol=0, atol=0)
    np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=-1), 1.0,
                               atol=1e-6)
