"""Port's frontend normalize, pooling, L2 and whitening against the JAX ops,
on the same seeded numpy inputs.

Tolerances: elementwise ops and poolings in f32 agree to 1e-5 relative
(summation order of the means differs); bf16 outputs to one bf16 ulp
(2^-8 relative). Whitening eigenvectors are sign-ambiguous and the two
eigensolvers differ (f32 in JAX, f64 in the port), so the fit is compared
through the whitened Gram matrices, as tests/parity/test_pipeline_oracle.py
does; applying the SAME (P, mu) must agree to 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instsearch_tpu.config import ExtractConfig
from instsearch_tpu.data import frontend as jfront
from instsearch_tpu.ops import pooling as jpool
from instsearch_tpu.ops import whitening as jwhite
from instsearch_torch.data import frontend as tfront
from instsearch_torch.ops import pooling as tpool
from instsearch_torch.ops import whitening as twhite


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_normalize(dtype):
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (2, 16, 16, 3), dtype=np.uint8)
    want = np.asarray(jfront.normalize(jnp.asarray(img),
                                       dtype=getattr(jnp, dtype)),
                      np.float32)
    got = tfront.normalize(torch.from_numpy(img),
                           dtype=getattr(torch, dtype)).float().numpy()
    tol = 1e-5 if dtype == "float32" else 2 ** -8
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    # float images already in [0, 1] take the same path without the /255
    f = (img / 255.0).astype(np.float32)
    np.testing.assert_allclose(
        tfront.normalize(torch.from_numpy(f), dtype=torch.float32).numpy(),
        np.asarray(jfront.normalize(jnp.asarray(f), dtype=jnp.float32)),
        rtol=1e-5, atol=1e-5)


def test_rescale_identity_and_not_ported():
    """Scale 1 returns the images as they are; any other scale is ported
    now and resizes as the reference does (tests/test_torch_resize.py)."""
    x = np.random.default_rng(5).standard_normal((1, 8, 8, 3)).astype(
        np.float32)
    t = torch.from_numpy(x)
    assert tfront.rescale(t, 1.0) is t
    np.testing.assert_allclose(tfront.rescale(t, 0.5).numpy(),
                               np.asarray(jfront.rescale(jnp.asarray(x), 0.5)),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("pooling", ["avg", "mac", "gem"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pooling(pooling, dtype):
    rng = np.random.default_rng(1)
    fmap = np.maximum(rng.standard_normal((3, 5, 7, 32)), 0).astype(
        np.float32)
    cfg = ExtractConfig(pooling=pooling, gem_p=3.0)
    want = np.asarray(jpool.pool(jnp.asarray(fmap, getattr(jnp, dtype)), cfg),
                      np.float32)
    got = tpool.pool(torch.from_numpy(fmap).to(getattr(torch, dtype)),
                     cfg).float().numpy()
    tol = 1e-5 if dtype == "float32" else 2 ** -7
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def test_rmac_not_ported():
    """R-MAC was the one pooling left unported; ``pool`` now dispatches it
    at the config's levels, equal to JAX's (tests/test_torch_rmac.py holds
    the grid and the rounding points)."""
    rng = np.random.default_rng(3)
    fmap = np.maximum(rng.standard_normal((2, 6, 9, 16)), 0).astype(
        np.float32)
    for levels in (1, 3):
        cfg = ExtractConfig(pooling="rmac", rmac_levels=levels)
        want = np.asarray(jpool.pool(jnp.asarray(fmap), cfg))
        got = tpool.pool(torch.from_numpy(fmap), cfg).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="unknown pooling"):
        tpool.pool(torch.zeros((1, 4, 4, 8)), ExtractConfig(pooling="spoc"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_l2_normalize(dtype):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, 64)).astype(np.float32)
    x[0] = 0.0                                  # eps floor, no NaN
    want = np.asarray(jpool.l2_normalize(jnp.asarray(x, getattr(jnp, dtype))),
                      np.float32)
    got = tpool.l2_normalize(torch.from_numpy(x).to(getattr(torch, dtype))
                             ).float().numpy()
    tol = 1e-6 if dtype == "float32" else 2 ** -8
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.fixture(scope="module")
def descs():
    rng = np.random.default_rng(3)
    # anisotropic unit descriptors, as pooled CNN features are
    db = rng.standard_normal((200, 48)) * np.linspace(3.0, 0.2, 48)
    q = rng.standard_normal((10, 48)) * np.linspace(3.0, 0.2, 48)
    db /= np.linalg.norm(db, axis=1, keepdims=True)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return db.astype(np.float32), q.astype(np.float32)


@pytest.mark.parametrize("dim", [None, 32, 500])
def test_whitening_gram_matches(descs, dim):
    db, q = descs
    wj = jwhite.fit_whitening(jnp.asarray(db), dim=dim)
    wt = twhite.fit_whitening(torch.from_numpy(db), dim=dim)
    assert tuple(wt.P.shape) == tuple(wj.P.shape)   # same rank clamp
    gj = (np.asarray(jwhite.apply_whitening(jnp.asarray(q), wj))
          @ np.asarray(jwhite.apply_whitening(jnp.asarray(db), wj)).T)
    gt = (twhite.apply_whitening(torch.from_numpy(q), wt)
          @ twhite.apply_whitening(torch.from_numpy(db), wt).T).numpy()
    np.testing.assert_allclose(gt, gj, rtol=1e-4, atol=1e-4)


def test_whitening_rank_clamp():
    """Fewer descriptors than dims: at most n-1 components are kept."""
    x = np.random.default_rng(4).standard_normal((10, 32)).astype(np.float32)
    wt = twhite.fit_whitening(torch.from_numpy(x))
    assert wt.P.shape == (9, 32)
    assert torch.isfinite(wt.P).all()


def test_apply_whitening_same_params(descs):
    db, q = descs
    wj = jwhite.fit_whitening(jnp.asarray(db), dim=40)
    wt = twhite.WhiteningParams(P=torch.from_numpy(np.array(wj.P)),
                                mu=torch.from_numpy(np.array(wj.mu)))
    want = np.asarray(jwhite.apply_whitening(jnp.asarray(q), wj))
    got = twhite.apply_whitening(torch.from_numpy(q), wt).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
