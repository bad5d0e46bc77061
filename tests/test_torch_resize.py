"""``ops/resize.py::resize_bilinear`` and the multi-scale
``data/frontend.py::rescale`` against ``jax.image.resize`` and the
reference's ``rescale``, on the same seeded inputs.

Tolerance: 1e-5 in f32. Both sides weight the same source pixels with the
same triangle kernel (widened by the scale factor when shrinking, which
``antialias=True`` does on the PyTorch side) and differ only in the order of
the weighted sums.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instsearch_tpu.data import frontend as jfront
from instsearch_torch.data import frontend as tfront
from instsearch_torch.ops.resize import resize_bilinear


@pytest.mark.parametrize("src,dst", [
    ((14, 14), (64, 64)), ((14, 14), (10, 10)), ((32, 24), (24, 40)),
    ((16, 16), (6, 6)), ((7, 9), (7, 5)), ((4, 4), (4, 4))])
def test_resize_bilinear_matches_jax(src, dst):
    x = np.random.default_rng(0).standard_normal(
        (2, *src, 5)).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), (2, *dst, 5), method="bilinear")
    got = resize_bilinear(torch.from_numpy(x), dst)
    assert tuple(got.shape) == (2, *dst, 5) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_resize_bilinear_keeps_the_dtype():
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (1, 8, 8, 3)).astype(np.float32))
    got = resize_bilinear(x.to(torch.bfloat16), (6, 6))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               resize_bilinear(x, (6, 6)).numpy(),
                               rtol=2 ** -7, atol=2 ** -7)


@pytest.mark.parametrize("scale", [0.75, 1.5, 0.5, 1.0])
@pytest.mark.parametrize("size", [32, 37])
def test_rescale_matches_jax(scale, size):
    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, (2, size, size, 3), dtype=np.uint8)
    x = np.array(jfront.normalize(jnp.asarray(img), dtype=jnp.float32))
    want = np.asarray(jfront.rescale(jnp.asarray(x), scale))
    got = tfront.rescale(torch.from_numpy(x), scale).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
