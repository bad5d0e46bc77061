#!/usr/bin/env python3
"""K4 (``pq_topk``) built from a copy of its sources, in variants, on one GPU:
the removal runs of a redesign.

    python3 tools/pq_variants.py --src DIR --variants NAME:FLAGS[,...]
        [--shapes ROWS:B:K[,...]] [--qb QB] [--ctas N]

DIR holds a copy of ``pq_scan.cu`` and the headers it includes (made in a
git-ignored directory, with parts of the kernel put under ``#ifdef``
switches by hand); each variant ``NAME:FLAGS`` is that copy compiled by its
own ``nvcc`` with the extra FLAGS (``base:`` none, ``nofold:-DNO_FOLD``),
all at once, into ``_build_variants/`` of this checkout. Each variant's
library takes the place of the package's K4 entries (``isf_pq_*``) under
this checkout's wrapper, which must match its C signature; the first
variant's build prints ptxas's registers and spills. For each variant and
shape (default: 1M rows at B = 1, 8, 128 and k = 10, 100; 64M rows at B =
1, 128 and k = 100; M = 64, D = 512, seeded random codes and codebook) it
prints one JSON line with the CUDA-event median of the wrapper (``ms``)
and the device time a call under ``torch.profiler`` by kernel (``pass1_ms``,
``pass2_ms``, ``other_ms``) and ``host_ms``, the rest. A variant's answers
are not checked: a removal gives wrong ones. ``--qb`` caps the query block
the plan may take, ``--ctas`` the pass-1 blocks it plans an SM. Every line
carries the card's nvidia-smi name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = ("1048576:1:10,1048576:1:100,1048576:8:10,1048576:8:100,"
          "1048576:128:10,1048576:128:100,67108864:1:100,67108864:128:100")


def _chip_smoke():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _build(src: str, variants) -> dict:
    """One nvcc per variant, all at once; returns the loaded libraries."""
    from instsearch_torch.kernels import _build as pkg_build
    out = os.path.join(HERE, "_build_variants")
    os.makedirs(out, exist_ok=True)
    nvcc = pkg_build._nvcc()
    jobs = []
    for i, (name, flags) in enumerate(variants):
        lib = os.path.join(out, f"lib_{name}.so")
        cmd = [nvcc, *pkg_build.NVCC_FLAGS, *(["-Xptxas", "-v"] if i == 0
                                               else []),
               *flags.split(), "-I", src, "-shared", "-o", lib,
               os.path.join(src, "pq_scan.cu")]
        jobs.append((name, lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    libs = {}
    for name, lib, proc in jobs:
        text = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"variant {name} failed to build:\n{text}")
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "entry" in line:
                print(line)
        libs[name] = ctypes.CDLL(lib)
    return libs


class _Variant:
    """The package's library with its K4 entries taken from a variant."""

    def __init__(self, real, variant):
        self.real, self.variant = real, variant

    def __getattr__(self, name):
        if not name.startswith("isf_pq"):
            return getattr(self.real, name)
        fn, decl = getattr(self.variant, name), getattr(self.real, name)
        fn.argtypes, fn.restype = decl.argtypes, decl.restype
        return fn


def device_split(fn, reps: int) -> dict:
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
        if e.device_type == DeviceType.CUDA:
            key = ("pass1_ms" if "pass1" in e.name else
                   "pass2_ms" if "pass2" in e.name else "other_ms")
            split[key] += e.time_range.elapsed_us() / 1e3 / reps
    return split


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", required=True, help="directory of the copy")
    ap.add_argument("--variants", required=True,
                    help="NAME:FLAGS[,...], e.g. base:,nofold:-DNO_FOLD")
    ap.add_argument("--shapes", default=SHAPES, help="ROWS:B:K[,...]")
    ap.add_argument("--qb", type=int, help="widest query block to plan")
    ap.add_argument("--ctas", type=int, help="pass-1 blocks an SM to plan")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("pq_variants: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from instsearch_torch.kernels import _build as pkg_build
    import instsearch_torch.kernels.pq_scan as pq_scan
    from instsearch_torch.ops.pq import PQCodebook
    cs = _chip_smoke()
    variants = [v.split(":", 1) for v in args.variants.split(",")]
    real = pkg_build.load()
    libs = _build(os.path.abspath(args.src), variants)
    if args.qb:
        pq_scan._QB_PQ = (1, args.qb)
    if args.ctas:
        sys.modules["instsearch_torch.kernels.topk_matmul"]._CTAS_PER_SM = (
            args.ctas)
    card = cs.card_line()
    print(card, flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    cb = PQCodebook(0.25 * torch.randn(64, 16, 8, generator=gen,
                                       device="cuda"))
    shapes = [tuple(int(v) for v in s.split(":"))
              for s in args.shapes.split(",")]
    codes = {n: torch.randint(-128, 128, (n, 32), generator=gen,
                              device="cuda", dtype=torch.int8)
             for n in sorted({n for n, _, _ in shapes})}
    queries = {b: cs.unit_rows(gen, b, 512, torch.float32)
               for b in sorted({b for _, b, _ in shapes})}
    load = pkg_build.load
    try:
        for name, _ in variants:
            lib = _Variant(real, libs[name])
            pkg_build.load = lambda lib=lib: lib
            pq_scan._pq_plan.cache_clear()
            for n, b, k in shapes:
                x, q = codes[n], queries[b]
                big = n * b > (1 << 26)

                def call():
                    return pq_scan.pq_topk(x, q, cb, k=k)

                ms = cs.cuda_median_ms(call, reps=5 if big else 20,
                                       warmup=2)
                split = device_split(call, 3 if big else 10)
                cs.report(card, variant=name, rows=n, b=b, k=k, ms=ms,
                          **split, host_ms=ms - sum(split.values()))
    finally:
        pkg_build.load = load
        pq_scan._pq_plan.cache_clear()
    return 0


if __name__ == "__main__":
    sys.exit(main())
