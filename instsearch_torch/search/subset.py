"""Subset (filtered) search: an allow-list over the store's row positions
(port of ``instsearch_tpu/search/subset.py``).

A subset is a ``[1, N_pad]`` int8 mask on the store's device, 1 where a row
may be returned. It is the operand the fused top-k kernels already take
(K1-K3, ``kernels/topk_matmul.py``; K4, ``kernels/pq_scan.py``): they fold
it into the same predicate that keeps padding rows out, so a filtered
top-k is exact over the subset. The scoring oracle folds it into the
padding mask; the PQ cascade applies it at ADC selection, so the whole
depth goes to allowed rows.

Returned ids are always members; a subset with fewer than k members comes
back with a tail of ``(-inf, -1)``, like padding. Rows added after a filter
was built are not members. ``Index.remove`` moves row positions and an
``Index.add`` past capacity re-pads the store, so both bump the index's
layout generation, and ``Index.search`` refuses a filter of another
generation or another padded size instead of filtering the wrong rows.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch


@dataclass(frozen=True)
class SubsetFilter:
    """Allow-list over index row positions, built by ``Index.make_subset``
    and passed to ``search``/``query``/``query_images``/``search_range``
    as ``subset=``. Reusable across queries."""

    mask: torch.Tensor                   # [1, N_pad] int8; 1 = allowed
    count: int                           # number of allowed rows
    layout_gen: int                      # Index._layout_gen at build time
    n_pad: int                           # padded row count at build time
    names: Optional[tuple] = None        # member names (serving rebuilds)

    def __repr__(self) -> str:
        return (f"SubsetFilter(count={self.count}, n_pad={self.n_pad}, "
                f"layout_gen={self.layout_gen})")


def build_position_mask(index, names: Optional[Sequence[str]] = None,
                        ids: Optional[Sequence[int]] = None,
                        mask=None) -> np.ndarray:
    """A subset spec -> ``[N_pad]`` bool position mask on the host. Exactly
    one of ``names`` (image names), ``ids`` (dataset ids, the values
    ``search`` returns) or ``mask`` (``[N_pad]`` over row positions, ANDed
    with the valid rows). Unknown names or ids raise ``KeyError``."""
    n_pad = index.n_pad
    if sum(x is not None for x in (names, ids, mask)) != 1:
        raise ValueError("pass exactly one of names=, ids=, mask=")
    if mask is not None:
        m = np.asarray(mask.cpu() if isinstance(mask, torch.Tensor) else mask)
        if m.shape != (n_pad,):
            raise ValueError(f"mask must be [{n_pad}] over padded row "
                             f"positions, got {m.shape}")
        return m.astype(bool) & (index.ids.cpu().numpy() >= 0)
    m = np.zeros((n_pad,), bool)
    if names is not None:
        pos_by_name = {nm: p for p, nm in enumerate(index.names)}
        missing = [nm for nm in names if nm not in pos_by_name]
        if missing:
            raise KeyError(f"{len(missing)} subset names not in the index "
                           f"(e.g. {missing[:3]})")
        m[[pos_by_name[nm] for nm in names]] = True
    else:
        ids_np = index.ids[:index.num_valid].cpu().numpy()
        pos_by_id = {int(v): p for p, v in enumerate(ids_np)}
        want = [int(i) for i in ids]
        missing = [i for i in want if i not in pos_by_id]
        if missing:
            raise KeyError(f"{len(missing)} subset ids not in the index "
                           f"(e.g. {missing[:3]})")
        m[[pos_by_id[i] for i in want]] = True
    return m
