"""The port's per-row quantization (instsearch_torch.ops.quantize) against
the JAX reference's (instsearch_tpu.ops.quantize) on the same f32 inputs.

Tolerance: none. Values, scales and packed bytes must be byte-identical,
since the two packages' stores are made from the same f32 rows by these
functions and must agree without a converter. That covers round-half-to-
even (``torch.round`` and ``jnp.round`` both), the +-127 / +-7 extremes,
the 1e-12 floor of an all-zero row, and the split-half offset nibbles
``16 * hi + (lo + 8)``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instsearch_tpu.ops import quantize as jq
from instsearch_torch.ops import quantize as tq


def _rows(kind: str, d: int) -> np.ndarray:
    rng = np.random.default_rng(d)
    if kind == "normal":
        return rng.standard_normal((33, d)).astype(np.float32)
    if kind == "unit":
        x = rng.standard_normal((33, d)).astype(np.float32)
        return x / np.linalg.norm(x, axis=1, keepdims=True)
    if kind == "zero":
        x = rng.standard_normal((6, d)).astype(np.float32)
        x[[1, 4]] = 0.0
        return x
    if kind == "tiny":                       # absmax below the 1e-12 floor
        return (rng.standard_normal((4, d)) * 1e-14).astype(np.float32)
    raise ValueError(kind)


def _halves(levels: int, d: int) -> np.ndarray:
    """Rows whose scale comes out exactly 1 (absmax == levels), the rest
    exact .5 values, so every component is a rounding tie."""
    ties = np.arange(d, dtype=np.float32) % (2 * levels - 1) - (levels - 1)
    row = ties + np.where(ties < 0, -0.5, 0.5).astype(np.float32)
    row = np.clip(row, -levels + 0.5, levels - 0.5)
    row[0], row[1] = levels, -levels            # the extremes set the scale
    return np.stack([row, -row])


def _same(t: torch.Tensor, j) -> None:
    j = np.asarray(j)
    assert t.dtype == torch.from_numpy(np.zeros(0, j.dtype)).dtype
    assert tuple(t.shape) == j.shape
    np.testing.assert_array_equal(t.numpy().view(np.uint8),
                                  j.view(np.uint8))


@pytest.mark.parametrize("kind", ["normal", "unit", "zero", "tiny"])
@pytest.mark.parametrize("d", [55, 64, 512])
def test_int8_byte_identical(kind, d):
    x = _rows(kind, d)
    t, j = tq.quantize_rows(torch.from_numpy(x)), jq.quantize_rows(
        jnp.asarray(x))
    _same(t.values, j.values)
    _same(t.scales, j.scales)
    _same(tq.dequantize_rows(t), jq.dequantize_rows(j))


@pytest.mark.parametrize("kind", ["normal", "unit", "zero", "tiny"])
@pytest.mark.parametrize("d", [56, 128, 512])
def test_int4_byte_identical(kind, d):
    x = _rows(kind, d)
    t, j = tq.quantize_rows_int4(torch.from_numpy(x)), jq.quantize_rows_int4(
        jnp.asarray(x))
    _same(t.values, j.values)
    _same(t.scales, j.scales)
    _same(tq.unpack_int4(t.values), jq.unpack_int4(j.values))
    _same(tq.dequantize_rows_int4(t), jq.dequantize_rows_int4(j))


@pytest.mark.parametrize("levels", [127, 7])
def test_half_ties_round_to_even(levels):
    x = _halves(levels, 64)
    if levels == 127:
        t, j = tq.quantize_rows(torch.from_numpy(x)), jq.quantize_rows(
            jnp.asarray(x))
        got = t.values.to(torch.int32).numpy()
    else:
        t, j = tq.quantize_rows_int4(torch.from_numpy(x)), \
            jq.quantize_rows_int4(jnp.asarray(x))
        got = tq.unpack_int4(t.values).to(torch.int32).numpy()
    _same(t.values, j.values)
    np.testing.assert_array_equal(t.scales.numpy(), np.ones((1, 2)))
    np.testing.assert_array_equal(got, np.round(x).astype(np.int32))
    assert got.max() == levels and got.min() == -levels
    odd_ties = np.abs(x - np.trunc(x)) == 0.5
    assert (got[odd_ties] % 2 == 0).all()        # halves went to even


def test_int4_layout_and_odd_width():
    x = np.array([[7, -7, 3, -1, 0, 5, -6, 2]], np.float32)
    t = tq.quantize_rows_int4(torch.from_numpy(x))
    lo, hi = x[0, :4].astype(np.int32), x[0, 4:].astype(np.int32)
    want = (16 * hi + lo + 8).astype(np.int8)
    np.testing.assert_array_equal(t.values.numpy()[0], want)
    np.testing.assert_array_equal(tq.unpack_int4(t.values).numpy(),
                                  x.astype(np.int8))
    with pytest.raises(ValueError, match="even D"):
        tq.quantize_rows_int4(torch.zeros((2, 55)))
    with pytest.raises(ValueError, match="even D"):
        jq.quantize_rows_int4(jnp.zeros((2, 55)))
