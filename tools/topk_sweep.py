#!/usr/bin/env python3
"""The fused top-k kernel against its plain version over query batch, k and
row width, on one GPU.

    python3 tools/topk_sweep.py [--rows 1048576] [--dtype bfloat16]

Run from the root of a checkout. On a seeded store of unit rows it prints,
for each shape, one JSON line with the CUDA-event medians (after warm-up) of
``topk_matmul`` (the CUDA kernel) and ``topk_matmul_reference`` (the plain
version) and the largest score difference; every answer is first held to
the plain version's by ``check_against_plain``. Every line carries the
card's nvidia-smi name and power limit.
"""
from __future__ import annotations

import argparse
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import SCORE_TOL, card_line, cuda_median_ms, report  # noqa: E402
from instsearch_torch.kernels.topk_matmul import (  # noqa: E402
    check_against_plain, topk_matmul, topk_matmul_reference)

SHAPES = ([(512, b, k) for b in (1, 2, 4, 8, 16, 32, 128) for k in (10, 100)]
          + [(2048, b, k) for b in (1, 8) for k in (10, 100)])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=1 << 20)
    ap.add_argument("--dtype", choices=("bfloat16", "float32"),
                    default="bfloat16")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("topk_sweep: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    dtype = getattr(torch, args.dtype)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def unit(n, d):
        x = torch.randn(n, d, generator=gen, device="cuda")
        return x / x.norm(dim=1, keepdim=True)

    for d in sorted({d for d, _, _ in SHAPES}):
        x = unit(args.rows, d).to(dtype)
        for _, b, k in (s for s in SHAPES if s[0] == d):
            q = unit(b, d)
            s, i = topk_matmul(x, q, k=k)
            rs, ri = topk_matmul_reference(x, q, k=k)
            err = check_against_plain(x, q, s, i, rs, ri, SCORE_TOL)
            report(card, rows=args.rows, d=d, b=b, k=k, dtype=args.dtype,
                   max_abs_err=err,
                   ms=cuda_median_ms(lambda: topk_matmul(x, q, k=k)),
                   plain_ms=cuda_median_ms(
                       lambda: topk_matmul_reference(x, q, k=k), reps=5))
        del x
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
