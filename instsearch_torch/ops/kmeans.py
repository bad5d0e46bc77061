"""Row chunking for the clustering fits (port of
``instsearch_tpu/ops/kmeans.py::pick_chunk``). Spherical k-means, the IVF
tier's coarse quantizer, is not ported yet (ROADMAP M9)."""
from __future__ import annotations


def pick_chunk(n: int, want: int = 16384) -> int:
    """Largest divisor of ``n`` that is <= ``want``: the fits and encoders
    walk the rows in equal slices of this many rows, as the reference does."""
    c = min(want, n)
    while n % c:
        c -= 1
    return c
