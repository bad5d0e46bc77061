"""Symmetric per-row int8 and int4 quantization of descriptors (port of
``instsearch_tpu/ops/quantize.py``).

The outputs are byte-identical to the reference's on the same f32 input:
the same f32 arithmetic (the scale is a product with the f32 reciprocal of
127 or 7, see ``_scale``), the same 1e-12 floor on the row's absolute
maximum, and ``torch.round`` rounds halves to even as ``jnp.round`` does.

    score(q, x) = (q_i8 . x_i8) * q_scale * x_scale     int8, scale max|row|/127
    score(q, x) = (q_i8 . x_i4) * q_scale * x_scale     int4, scale max|row|/7

int4 layout (split halves, offset low nibble): byte ``j`` of a row holds
component ``j`` in its low nibble, stored as ``lo + 8`` (in [1, 15]), and
component ``j + D/2`` in its high nibble as plain two's complement, so
``byte = 16 * hi + (lo + 8)`` and ``hi = byte >> 4`` (arithmetic shift).
Every consumer unpacks through ``unpack_int4``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class QuantizedRows(NamedTuple):
    values: torch.Tensor    # int8 [N, D] (int4: [N, D // 2] nibble pairs)
    scales: torch.Tensor    # f32 [1, N]


def _scale(xf: torch.Tensor, levels: float) -> torch.Tensor:
    """max(max|row|, 1e-12) / levels, as the reference's compiled program
    computes it: XLA turns the division by a constant into a product with
    the constant's f32 reciprocal, which can differ from the quotient in
    the last bit."""
    absmax = xf.abs().amax(dim=1, keepdim=True)                  # [N, 1]
    return absmax.clamp_min(1e-12) * torch.tensor(1.0 / levels,
                                                  dtype=torch.float32)


def quantize_rows(x: torch.Tensor) -> QuantizedRows:
    """Per-row symmetric int8: scale = max|row| / 127."""
    xf = x.to(torch.float32)
    scale = _scale(xf, 127.0)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return QuantizedRows(values=q, scales=scale.reshape(1, -1))


def dequantize_rows(qr: QuantizedRows) -> torch.Tensor:
    return qr.values.to(torch.float32) * qr.scales.reshape(-1, 1)


def quantize_rows_int4(x: torch.Tensor) -> QuantizedRows:
    """Per-row symmetric int4: scale = max|row| / 7; D must be even."""
    xf = x.to(torch.float32)
    d = xf.shape[1]
    if d % 2:
        raise ValueError(f"int4 packing needs even D, got {d}")
    scale = _scale(xf, 7.0)
    q = torch.clamp(torch.round(xf / scale), -7, 7)
    return QuantizedRows(values=pack_int4(q), scales=scale.reshape(1, -1))


def pack_int4(components: torch.Tensor) -> torch.Tensor:
    """Components in [-7, 7] ``[..., D]`` (D even) -> ``[..., D // 2]``
    nibble pairs, component ``j`` with ``j + D/2``: the inverse of
    ``unpack_int4``. Repacking over another D pairs other components (the
    index's zero columns move the half point)."""
    c = components.to(torch.int32)
    d = c.shape[-1]
    lo = c[..., :d // 2] + 8                # offset low nibble, in [1, 15]
    hi = c[..., d // 2:]
    return (hi * 16 + lo).to(torch.int8)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """int8 ``[..., D // 2]`` packed nibbles -> int8 ``[..., D]`` components
    in logical order."""
    b = packed.to(torch.int32)
    hi = b >> 4                     # arithmetic shift: exact signed hi
    lo = (b & 0xF) - 8              # remove the storage offset
    return torch.cat([lo, hi], dim=-1).to(torch.int8)


def dequantize_rows_int4(qr: QuantizedRows) -> torch.Tensor:
    return (unpack_int4(qr.values).to(torch.float32)
            * qr.scales.reshape(-1, 1))
