#!/usr/bin/env python3
"""Where K1's bf16 pass 1 (``instsearch_torch/csrc/topk_wgmma.cuh``) spends
its time, on one GPU.

    python3 tools/k1_profile.py [--rows 1048576]
        [--shapes 512:128:10,512:128:100,2048:128:10,2048:128:200]

Builds three forms of ``csrc/topk_matmul.cu`` from this checkout's sources,
each into a scratch folder of its own under the system's temporary
directory (the package's build is untouched), and times them on a seeded
store of unit bf16 rows, the forms in turn, twice each:
  * ``kernel``: the sources as they are (every answer first held to the
    plain version by ``check_against_plain``);
  * ``products``: the tile's selection (``epilogue()``) taken out: the TMA
    ring and the products alone, the floor the selection adds to;
  * ``clocked``: the kernel with ``clock64()`` counters per consumer warp,
    summed over the warps of one call: cycles waiting for a stage, in the
    tile's selection, in its first appends, in the rounds (merges and the
    appends after them), in merges; merges and rounds counted.
Each shape prints one JSON line with the card's nvidia-smi name and power
limit: ``ms`` per form (CUDA-event medians of the wrapper) and, per
consumer warp, the ``clocked`` form's counters. First, the host time of
encoding one query's TMA map at B = 1 (``query_map_us_b1``, the mean of
10,000; every call encodes one, the store's map is cached). The forms are
made by replacing lines of the kernel's source; a line that is no longer
there stops the tool with its text.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import shutil
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

SHAPES = "512:128:10,512:128:100,2048:128:10,2048:128:200"
EPILOGUE = "    epilogue();\n"
COUNTERS = ("wait", "selection", "first_appends", "rounds", "merges_clk",
            "merges", "rounds_n", "all")
# (line, replacement) pairs, in topk_wgmma.cuh
FORMS = {
    "kernel": [],
    "products": [(EPILOGUE, "")],
    "clocked": [
        ("namespace {\n\nconstexpr int kWgConsumers",
         "__device__ unsigned long long isf_clk[8];\nnamespace {\n\n"
         "constexpr int kWgConsumers"),
        ("  auto settle = [&]() {",
         "  long long c_[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n"
         "  const long long c_start = clock64();\n"
         "  auto settle = [&]() {"),
        ("      mbar_wait(&full[s], ph);\n      settle();",
         "      { const long long t0 = clock64(); mbar_wait(&full[s], ph);\n"
         "        c_[0] += clock64() - t0; }\n      settle();"),
        (EPILOGUE, "    { const long long t0 = clock64(); epilogue();\n"
                   "      c_[1] += clock64() - t0; }\n"),
        ("    uint64_t left = append(bits);\n",
         "    const long long a0 = clock64();\n"
         "    uint64_t left = append(bits);\n"
         "    const long long a1 = clock64();\n    c_[2] += a1 - a0;\n"),
        ("          if (seen % 4 != v) continue;\n",
         "          if (seen % 4 != v) continue;\n          ++c_[5];\n"
         "          const long long m0 = clock64();\n"),
        ("          if (lane == 0) {\n            cnt[ql] = 0;",
         "          c_[4] += clock64() - m0;\n"
         "          if (lane == 0) {\n            cnt[ql] = 0;"),
        ("      named_barrier_sync(bar, 128);\n      left = append(left);\n"
         "    }\n",
         "      named_barrier_sync(bar, 128);\n      left = append(left);\n"
         "      ++c_[6];\n    }\n    c_[3] += clock64() - a1;\n"),
        ("  // the buffers' last entries, then the lists",
         "  c_[7] = clock64() - c_start;\n"
         "  if (lane == 0)\n    for (int i = 0; i < 8; ++i)\n"
         "      atomicAdd(isf_clk + i, (unsigned long long)c_[i]);\n"
         "  // the buffers' last entries, then the lists"),
    ],
}
READ_CLOCKS = """
#include <chrono>
extern "C" void isf_clk_read(unsigned long long* out) {
  const unsigned long long zero[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  cudaMemcpyFromSymbol(out, isf_clk, sizeof(zero));
  cudaMemcpyToSymbol(isf_clk, zero, sizeof(zero));
}
// host microseconds to encode the query's TMA map, as every call does
extern "C" double isf_query_map_us(const void* q, int b, int d, int qb,
                                   int reps) {
  const hopper::EncodeTiled encode = hopper::encode_tiled();
  CUtensorMap map;
  const auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < reps; ++i) wg_rows_map(&map, encode, q, b, d, qb);
  return std::chrono::duration<double, std::micro>(
             std::chrono::steady_clock::now() - t0).count() / reps;
}
"""


def build(form: str, edits, tmp: str) -> subprocess.Popen:
    """Copy the sources into tmp/form, apply the form's edits, start nvcc
    on topk_matmul.cu alone; returns the process (the library is
    tmp/form/lib.so)."""
    src = os.path.join(tmp, form)
    shutil.copytree(os.path.join(HERE, "instsearch_torch", "csrc"), src)
    path = os.path.join(src, "topk_wgmma.cuh")
    with open(path) as f:
        text = f.read()
    for line, new in edits:
        if line not in text:
            raise SystemExit(f"k1_profile: {form}: the kernel no longer "
                             f"has the line\n{line}")
        text = text.replace(line, new)
    with open(path, "w") as f:
        f.write(text)
    if form == "clocked":
        with open(os.path.join(src, "topk_matmul.cu"), "a") as f:
            f.write(READ_CLOCKS)
    from instsearch_torch.kernels import _build
    return subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
         os.path.join(src, "lib.so"), os.path.join(src, "topk_matmul.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=1 << 20)
    ap.add_argument("--shapes", default=SHAPES, help="D:B:k,...")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("k1_profile: needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from instsearch_torch.kernels import _build
    from instsearch_torch.kernels.topk_matmul import (check_against_plain,
                                                      topk_matmul,
                                                      topk_matmul_reference)
    tmp = tempfile.mkdtemp(prefix="k1_profile_")
    try:
        procs = {form: build(form, edits, tmp)
                 for form, edits in FORMS.items()}
        libs = {}
        p, i = ctypes.c_void_p, ctypes.c_int
        for form, proc in procs.items():
            out = proc.communicate()[0]
            if proc.returncode:
                print(out[-4000:], file=sys.stderr)
                return 1
            lib = ctypes.CDLL(os.path.join(tmp, form, "lib.so"))
            lib.isf_topk_matmul_wgmma.argtypes = [p] * 7 + [i] * 8 + [p]
            lib.isf_topk_matmul_wgmma.restype = i
            libs[form] = lib
        card = cs.card_line()
        print(card, flush=True)
        enc = libs["clocked"].isf_query_map_us
        enc.argtypes = [p, i, i, i, i]
        enc.restype = ctypes.c_double
        for d in (512, 2048):
            q = torch.zeros((1, d), dtype=torch.bfloat16, device="cuda")
            cs.report(card, query_map_us_b1=enc(q.data_ptr(), 1, d, 8,
                                                10000), d=d)
        gen = torch.Generator(device="cuda").manual_seed(0)
        for shape in args.shapes.split(","):
            d, b, k = (int(v) for v in shape.split(":"))
            x = cs.unit_rows(gen, args.rows, d, torch.bfloat16)
            q = cs.unit_rows(gen, b, d, torch.float32)
            ms = {form: [] for form in libs}
            for _ in range(2):
                for form, lib in libs.items():
                    _build.load = lambda lib=lib: lib
                    if form != "products":
                        s, idx = topk_matmul(x, q, k=k)
                        rs, ri = topk_matmul_reference(x, q, k=k)
                        torch.cuda.synchronize()
                        check_against_plain(x, q, s, idx, rs, ri,
                                            cs.SCORE_TOL)
                    ms[form].append(cs.cuda_median_ms(
                        lambda: topk_matmul(x, q, k=k), reps=10))
            clk = (ctypes.c_ulonglong * 8)()
            libs["clocked"].isf_clk_read(clk)      # zero the counters
            _build.load = lambda: libs["clocked"]
            topk_matmul(x, q, k=k)
            torch.cuda.synchronize()
            libs["clocked"].isf_clk_read(clk)
            from instsearch_torch.kernels.topk_matmul import _bf16_plan
            qb, _, slices = _bf16_plan(args.rows, d, b, k, x.device)
            warps = 8 * slices * -(-b // qb)
            cs.report(card, rows=args.rows, d=d, b=b, k=k, query_block=qb,
                      ms=ms, per_consumer_warp={
                          name: clk[j] / warps
                          for j, name in enumerate(COUNTERS)})
            del x
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
