"""Fixed-size query chunking (port of ``instsearch_tpu/utils/chunking.py``).

Same chunk semantics as the reference: a batch larger than ``chunk`` runs
in ``chunk``-sized pieces, and the results concatenate. Eager PyTorch
compiles nothing per shape, so the last piece is NOT padded up to ``chunk``
(the reference pads so one compiled program serves every piece); a later
CUDA-graph capture that needs one shape can pad at its own call site.
"""
from __future__ import annotations

import torch


def _cat(outs):
    if isinstance(outs[0], tuple):
        return tuple(_cat(list(parts)) for parts in zip(*outs))
    return torch.cat(outs)


def run_chunked(run, chunk: int, *per_query):
    """Serve a query batch through ``run`` in pieces of at most ``chunk``.
    ``per_query`` tensors share the leading batch axis and are cut in
    lockstep; tuple results concatenate element-wise. ``chunk`` falsy or a
    batch <= chunk runs one pass."""
    b = per_query[0].shape[0]
    if not chunk or b <= chunk:
        return run(*per_query)
    outs = [run(*(a[i:i + chunk] for a in per_query))
            for i in range(0, b, chunk)]
    return _cat(outs)
