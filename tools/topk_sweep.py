#!/usr/bin/env python3
"""A fused top-k kernel against its plain version over query batch, k and
row width, on one GPU.

    python3 tools/topk_sweep.py [--rows 1048576]
                                [--dtype bfloat16|float32|int8|int4|pq]

Run from the root of a checkout. On a seeded store of unit rows (bf16/f32
for K1 ``topk_matmul``; quantized per row for K2 ``topk_matmul_int8`` and K3
``topk_matmul_int4``) or of random 4-bit PQ codes with M = D/8 subspaces
and a random codebook (K4 ``pq_topk``) it prints, for each shape, one JSON
line with the CUDA-event medians (after warm-up) of the wrapper (the CUDA
kernel, with the query's quantization for K2/K3 and the lookup table for
K4) and of its plain version, and the largest score difference; every
answer is first held to the plain version's (``check_against_plain``, or
``check_exact`` for K2-K4), and the device time per call under
``torch.profiler``, split into pass 1, pass 2 and the other device
operations. Every line carries the card's nvidia-smi name and power
limit.
"""
from __future__ import annotations

import argparse
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import (SCORE_TOL, card_line, cuda_median_ms,  # noqa: E402
                        quantized_unit_rows, report, unit_rows)
from instsearch_torch.kernels.pq_scan import (pq_topk,  # noqa: E402
                                               pq_topk_reference)
from instsearch_torch.kernels.topk_matmul import (  # noqa: E402
    check_against_plain, check_exact, topk_matmul, topk_matmul_int4,
    topk_matmul_int4_reference, topk_matmul_int8, topk_matmul_int8_reference,
    topk_matmul_reference)
from instsearch_torch.ops.pq import PQCodebook, default_m  # noqa: E402
from instsearch_torch.ops.quantize import (quantize_rows,  # noqa: E402
                                           quantize_rows_int4)

SHAPES = ([(512, b, k) for b in (1, 2, 4, 8, 16, 32, 64, 128)
           for k in (10, 100)]
          + [(2048, b, k) for b in (1, 8, 128) for k in (10, 100)])
_INT = {"int8": (quantize_rows, topk_matmul_int8, topk_matmul_int8_reference),
        "int4": (quantize_rows_int4, topk_matmul_int4,
                 topk_matmul_int4_reference)}


def device_split(fn, reps: int = 10) -> dict:
    """Device time per call of ``fn`` by torch.profiler: top-k pass 1, pass 2
    and everything else (the query's quantization, copies)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    split = {"pass1_ms": 0.0, "pass2_ms": 0.0, "other_ms": 0.0}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        key = ("pass1_ms" if "topk_pass1" in e.name else
               "pass2_ms" if "topk_pass2" in e.name else "other_ms")
        split[key] += e.time_range.elapsed_us() / 1e3 / reps
    if not split["pass1_ms"]:
        raise RuntimeError("the profiler recorded no top-k kernel")
    return split


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=1 << 20)
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("bfloat16", "float32", "int8", "int4", "pq"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("topk_sweep: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)

    for d in sorted({d for d, _, _ in SHAPES}):
        if args.dtype == "pq":
            m = default_m(d)
            codes = torch.randint(-128, 128, (args.rows, m // 2),
                                  generator=gen, device="cuda",
                                  dtype=torch.int8)
            cb = PQCodebook(0.25 * torch.randn(m, 16, d // m, generator=gen,
                                               device="cuda"))
            run = lambda q, k: pq_topk(codes, q, cb, k=k)  # noqa: E731
            plain = lambda q, k: pq_topk_reference(  # noqa: E731
                codes, q, cb, k=k)
        elif args.dtype in _INT:
            quantize, fn, ref = _INT[args.dtype]
            st = quantized_unit_rows(gen, args.rows, d, quantize)
            run = lambda q, k: fn(st.values, st.scales, q, k=k)  # noqa: E731
            plain = lambda q, k: ref(st.values, st.scales, q, k=k)  # noqa: E731
        else:
            x = unit_rows(gen, args.rows, d, getattr(torch, args.dtype))
            run = lambda q, k: topk_matmul(x, q, k=k)  # noqa: E731
            plain = lambda q, k: topk_matmul_reference(x, q, k=k)  # noqa: E731
        for _, b, k in (s for s in SHAPES if s[0] == d):
            q = unit_rows(gen, b, d, torch.float32)
            s, i = run(q, k)
            rs, ri = plain(q, k)
            err = (check_exact(s, i, rs, ri)
                   if args.dtype in _INT or args.dtype == "pq" else
                   check_against_plain(x, q, s, i, rs, ri, SCORE_TOL))
            report(card, rows=args.rows, d=d, b=b, k=k, dtype=args.dtype,
                   max_abs_err=err, ms=cuda_median_ms(lambda: run(q, k)),
                   plain_ms=cuda_median_ms(lambda: plain(q, k), reps=5),
                   **device_split(lambda: run(q, k)))
        st = x = codes = None
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
