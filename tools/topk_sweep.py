#!/usr/bin/env python3
"""A fused top-k kernel against its plain version over query batch, k and
row width, on one GPU.

    python3 tools/topk_sweep.py [--rows 1048576]
        [--dtype bfloat16|float32|int8|int4|pq[,...]]
        [--batches 1,8,128] [--ks 10,100] [--dims 512,2048]
        [--shapes D:B:k,...] [--root DIR | --pair PARENT_DIR]

Run from anywhere; the package comes from the checkout this file lies in,
or from ``--root``. On a seeded store of unit rows (bf16/f32 for K1
``topk_matmul``; quantized per row for K2 ``topk_matmul_int8`` and K3
``topk_matmul_int4``) or of random 4-bit PQ codes with M = D/8 subspaces
and a random codebook (K4 ``pq_topk``) it prints, for each shape, one JSON
line with the CUDA-event medians (after warm-up) of the wrapper (the CUDA
kernel, with the query's quantization for K2/K3 and the lookup table for
K4) and of its plain version, and the largest score difference; every
answer is first held to the plain version's (``check_against_plain``, or
``check_exact`` for K2-K4), and the device time per call under
``torch.profiler``, split into pass 1, pass 2 and the other device
operations (``pass1_ms``, ``pass2_ms``, ``other_ms``), and the host's
share, the call's ms less that device sum (``host_ms``). Above 16M rows
(``--rows 67108864``: K4 over ``bench_pq_capacity``'s 64M rows) the plain
version runs once, for the check, and is not timed (``plain_ms`` null).
K1 also times its yardstick, ``torch.topk(q @ x.T, k)`` in the store's
dtype (f32 with TF32 off, ``torch.get_float32_matmul_precision()``
"highest"), and K2 at B > 16 its own, one ``torch._int_mm`` of the
quantized query and rows, scaled, and ``torch.topk`` (``library_ms``;
``_int_mm`` needs more than 16 rows). ``bound_ms`` / ``bound_by`` are
``chip_smoke.bound`` of the store's bytes read once and the scores' 2 B N D
operations at the store's type; an f32 store also gets ``bound_ms_tf32x3``,
the same with three TF32 products a pair (its pass 1's split-TF32 work) at
the TF32 tensor cores' peak. ``tflops`` is the scores' 2 B N D operations
over the call's ms. Every line carries the card's nvidia-smi name and
power limit. ``--batches``, ``--ks`` and ``--dims`` keep only those
shapes; ``--shapes D:B:k,...`` replaces the list.

``--pair PARENT_DIR`` compares two trees on one card: it runs the sweep
from PARENT_DIR (for example ``git archive`` of the parent commit,
unpacked into a git-ignored directory), from this checkout, from this
checkout again and from PARENT_DIR again, each in a process of its own
that builds its tree's kernels, and tags each line with ``tree`` and
``run``. The timing code is this file's for both trees.
"""
from __future__ import annotations

import argparse
import importlib.util
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SHAPES = ([(512, b, k) for b in (1, 2, 4, 8, 16, 32, 64, 128)
           for k in (10, 100)]
          + [(2048, b, k) for b in (1, 8, 128) for k in (10, 100, 200)]
          # the l2 store over SIFT1M's shape (128 columns and the norm
          # column, padded to 136) at k = 10 and at search_range's 256
          + [(136, b, k) for b in (1, 128) for k in (10, 256)])
DTYPES = ("bfloat16", "float32", "int8", "int4", "pq")
# above this many rows the plain version runs once (the answer's check), and
# is not timed
_PLAIN_TIMED_ROWS = 1 << 24


def _chip_smoke():
    """This checkout's ``chip_smoke`` (its timing helpers), whatever
    ``--root`` is."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def device_split(fn, reps: int = 10) -> dict:
    """Device time per call of ``fn`` by torch.profiler: top-k pass 1 (any
    kernel named ``*pass1*``: K1-K3's ``topk_pass1_wgmma``, K4's
    ``pq_pass1``), pass 2 and everything else (K1's f32 query split, K2/K3's
    quantization, K4's table, copies)."""
    import torch
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
        key = ("pass1_ms" if "pass1" in e.name else
               "pass2_ms" if "topk_pass2" in e.name else "other_ms")
        split[key] += e.time_range.elapsed_us() / 1e3 / reps
    if not split["pass1_ms"]:
        raise RuntimeError("the profiler recorded no top-k kernel")
    return split


def sweep(rows: int, dtype: str, shapes, tags: dict) -> None:
    import torch
    cs = _chip_smoke()
    from instsearch_torch.kernels.pq_scan import pq_topk, pq_topk_reference
    from instsearch_torch.kernels.topk_matmul import (
        check_against_plain, check_exact, topk_matmul, topk_matmul_int4,
        topk_matmul_int4_reference, topk_matmul_int8,
        topk_matmul_int8_reference, topk_matmul_reference)
    from instsearch_torch.ops.pq import PQCodebook, default_m
    from instsearch_torch.ops.quantize import (quantize_rows,
                                               quantize_rows_int4)
    ints = {"int8": (quantize_rows, topk_matmul_int8,
                     topk_matmul_int8_reference),
            "int4": (quantize_rows_int4, topk_matmul_int4,
                     topk_matmul_int4_reference)}
    card = cs.card_line()
    gen = torch.Generator(device="cuda").manual_seed(0)
    exact = dtype in ints or dtype == "pq"

    for d in sorted({d for d, _, _ in shapes}):
        library = None
        if dtype == "pq":
            m = default_m(d)
            codes = torch.randint(-128, 128, (rows, m // 2), generator=gen,
                                  device="cuda", dtype=torch.int8)
            cb = PQCodebook(0.25 * torch.randn(m, 16, d // m, generator=gen,
                                               device="cuda"))
            run = lambda q, k: pq_topk(codes, q, cb, k=k)  # noqa: E731
            plain = lambda q, k: pq_topk_reference(  # noqa: E731
                codes, q, cb, k=k)
        elif dtype in ints:
            quantize, fn, ref = ints[dtype]
            st = cs.quantized_unit_rows(gen, rows, d, quantize)
            run = lambda q, k: fn(st.values, st.scales, q, k=k)  # noqa: E731
            plain = lambda q, k: ref(  # noqa: E731
                st.values, st.scales, q, k=k)
            if dtype == "int8":
                library = lambda q, k: cs.int_mm_topk(  # noqa: E731
                    st, q, k)
        else:
            x = cs.unit_rows(gen, rows, d, getattr(torch, dtype))
            run = lambda q, k: topk_matmul(x, q, k=k)  # noqa: E731
            plain = lambda q, k: topk_matmul_reference(  # noqa: E731
                x, q, k=k)
            def library(q, k, x=x):
                qx = q.to(x.dtype)
                return lambda: torch.topk(qx @ x.T, k)
        for _, b, k in (s for s in shapes if s[0] == d):
            big = rows > _PLAIN_TIMED_ROWS
            q = cs.unit_rows(gen, b, d, torch.float32)
            s, i = run(q, k)
            rs, ri = plain(q, k)
            err = (check_exact(s, i, rs, ri) if exact else
                   check_against_plain(x, q, s, i, rs, ri, cs.SCORE_TOL))
            lib_ms = (cs.cuda_median_ms(library(q, k))
                      if library is not None
                      and (b > 16 or dtype in ("bfloat16", "float32"))
                      else None)
            ms = cs.cuda_median_ms(lambda: run(q, k), reps=5 if big else 20)
            split = device_split(lambda: run(q, k), reps=3 if big else 10)
            cs.report(card, **tags, rows=rows, d=d, b=b, k=k, dtype=dtype,
                      max_abs_err=err, ms=ms,
                      **bounds(dtype, rows, d, b, k),
                      plain_ms=(None if big else cs.cuda_median_ms(
                          lambda: plain(q, k), reps=5)),
                      library_ms=lib_ms, **split,
                      host_ms=ms - sum(split.values()),
                      tflops=2 * b * rows * d / ms / 1e9)
        st = x = codes = library = None
        torch.cuda.empty_cache()


def bounds(dtype: str, rows: int, d: int, b: int, k: int) -> dict:
    """``chip_smoke.bound`` of one K1-K3 call (none for K4): the store read
    once (with K2/K3's row scales), the query read and the top-k written
    once, the 2 B N D operations of the scores at the store's type; for an
    f32 store also the bound of three TF32 products a pair
    (``bound_ms_tf32x3``)."""
    if dtype == "pq":
        return {}
    cs = _chip_smoke()
    row_bytes = {"bfloat16": 2 * d, "float32": 4 * d, "int8": d + 4,
                 "int4": d // 2 + 4}[dtype]
    nbytes = rows * row_bytes + b * d * 4 + b * k * 8
    ops = 2 * b * rows * d
    kind = {"bfloat16": "bf16", "float32": "f32"}.get(dtype, "int8")
    out = cs.bound(nbytes, ops, kind)
    if dtype == "float32":
        out["bound_ms_tf32x3"] = cs.bound(nbytes, 3 * ops, "tf32")["bound_ms"]
    return out


def _ints(text: "str | None"):
    return None if text is None else {int(v) for v in text.split(",")}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=1 << 20)
    ap.add_argument("--dtype", default="bfloat16",
                    help=f"comma-separated, of {', '.join(DTYPES)}")
    ap.add_argument("--batches", help="query batches to keep, e.g. 1,128")
    ap.add_argument("--ks", help="k values to keep, e.g. 10")
    ap.add_argument("--dims", help="row widths to keep, e.g. 512")
    ap.add_argument("--shapes", help="D:B:k,... in place of the list")
    ap.add_argument("--root", default=HERE,
                    help="checkout whose instsearch_torch is timed")
    ap.add_argument("--pair", metavar="PARENT_DIR",
                    help="run parent, this, this, parent, one process each")
    ap.add_argument("--tree", default="", help=argparse.SUPPRESS)
    ap.add_argument("--run", type=int, default=0, help=argparse.SUPPRESS)
    args = ap.parse_args()
    dtypes = args.dtype.split(",")
    if not set(dtypes) <= set(DTYPES):
        ap.error(f"--dtype: each of {', '.join(DTYPES)}")
    if args.pair:
        rc = 0
        passed = [f"--{name}={value}" for name, value in (
            ("rows", args.rows), ("dtype", args.dtype),
            ("batches", args.batches), ("ks", args.ks),
            ("dims", args.dims), ("shapes", args.shapes))
            if value is not None]
        for run, (tree, root) in enumerate((("parent", args.pair),
                                            ("change", HERE),
                                            ("change", HERE),
                                            ("parent", args.pair))):
            rc |= subprocess.run(
                [sys.executable, os.path.abspath(__file__), *passed,
                 f"--root={os.path.abspath(root)}", f"--tree={tree}",
                 f"--run={run}"]).returncode
        return rc
    import torch
    if not torch.cuda.is_available():
        print("topk_sweep: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    torch.backends.cuda.matmul.allow_tf32 = False
    if torch.get_float32_matmul_precision() != "highest":
        print("topk_sweep: f32 products must run in full f32",
              file=sys.stderr)
        return 1
    batches, ks, dims = _ints(args.batches), _ints(args.ks), _ints(args.dims)
    listed = (SHAPES if args.shapes is None else
              [tuple(int(v) for v in s.split(":"))
               for s in args.shapes.split(",")])
    shapes = [(d, b, k) for d, b, k in listed
              if (batches is None or b in batches)
              and (ks is None or k in ks) and (dims is None or d in dims)]
    print(_chip_smoke().card_line(), flush=True)
    tags = {"tree": args.tree, "run": args.run} if args.tree else {}
    for dtype in dtypes:
        sweep(args.rows, dtype, shapes, tags)
    return 0


if __name__ == "__main__":
    sys.exit(main())
