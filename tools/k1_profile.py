#!/usr/bin/env python3
"""Where the TMA + wgmma pass 1 (``instsearch_torch/csrc/topk_wgmma.cuh``)
of K1 (bf16 or f32 store), K2 (int8) or K3 (int4) spends its time, on one
GPU.

    python3 tools/k1_profile.py [--rows 1048576]
        [--dtype bfloat16,float32,int8,int4]
        [--shapes 512:128:10,512:128:100,2048:128:10,2048:128:200]

Builds three forms of ``csrc/topk_matmul.cu`` (K1) or
``csrc/topk_matmul_int.cu`` (K2/K3) from this checkout's sources, each into
a scratch folder of its own under the system's temporary directory (the
package's build is untouched), and times them on a seeded store of unit
rows (bf16, f32, or quantized per row to int8 / int4), the forms in turn,
twice
each:
  * ``kernel``: the sources as they are (every answer first held to the
    plain version by ``check_against_plain``, K2/K3 by ``check_exact``);
  * ``products``: the tile's selection (``epilogue()``, with K2/K3's
    scores formed from the sums) taken out: the TMA ring and the products
    alone, the floor the selection adds to;
  * ``clocked``: the kernel with ``clock64()`` counters per consumer warp,
    summed over the warps of one call: cycles waiting for a stage, in the
    tile's selection, in its first appends, in the rounds (merges and the
    appends after them), in merges; merges and rounds counted.
Each shape prints one JSON line with the card's nvidia-smi name and power
limit: ``ms`` per form (CUDA-event medians of the wrapper, K2/K3's query
quantization and pass 2 included) and, per consumer warp, the ``clocked``
form's counters. First, the host time of encoding one bf16 query's TMA map
at B = 1 (``query_map_us_b1``, the mean of 10,000; every call encodes one,
the store's map is cached). The forms are made by replacing lines of the
kernel's source; a line that is no longer there stops the tool with its
text.
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
        ("      if (kSplit) {\n        mbar_wait(",
         "      const long long w0_ = clock64();\n"
         "      if (kSplit) {\n        mbar_wait("),
        ("        mbar_wait(&full[s], ph);\n      }\n",
         "        mbar_wait(&full[s], ph);\n      }\n"
         "      c_[0] += clock64() - w0_;\n"),
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
  for (int i = 0; i < reps; ++i)
    wg_map(&map, encode, q, b, d, qb, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16);
  return std::chrono::duration<double, std::micro>(
             std::chrono::steady_clock::now() - t0).count() / reps;
}
"""


# the source each store kind's kernel is built from
SOURCES = {"bfloat16": "topk_matmul.cu", "float32": "topk_matmul.cu",
           "int8": "topk_matmul_int.cu", "int4": "topk_matmul_int.cu"}


def build(form: str, edits, tmp: str, source: str) -> subprocess.Popen:
    """Copy the sources into tmp/FORM_SOURCE, apply the form's edits,
    start nvcc on ``source`` alone; returns the process (the library is
    lib.so there)."""
    src = os.path.join(tmp, f"{form}_{source}")
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
        with open(os.path.join(src, source), "a") as f:
            f.write(READ_CLOCKS)
    from instsearch_torch.kernels import _build
    return subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
         os.path.join(src, "lib.so"), os.path.join(src, source)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=1 << 20)
    ap.add_argument("--dtype", default="bfloat16",
                    help=f"comma-separated, of {', '.join(SOURCES)}")
    ap.add_argument("--shapes", default=SHAPES, help="D:B:k,...")
    args = ap.parse_args()
    dtypes = args.dtype.split(",")
    if not set(dtypes) <= set(SOURCES):
        ap.error(f"--dtype: each of {', '.join(SOURCES)}")
    import torch
    if not torch.cuda.is_available():
        print("k1_profile: needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from instsearch_torch.kernels import _build
    tmp = tempfile.mkdtemp(prefix="k1_profile_")
    try:
        sources = sorted({SOURCES[t] for t in dtypes})
        procs = {(source, form): build(form, edits, tmp, source)
                 for source in sources for form, edits in FORMS.items()}
        libs = {}
        for (source, form), proc in procs.items():
            out = proc.communicate()[0]
            if proc.returncode:
                print(out[-4000:], file=sys.stderr)
                return 1
            lib = ctypes.CDLL(os.path.join(tmp, f"{form}_{source}",
                                           "lib.so"))
            p, i = ctypes.c_void_p, ctypes.c_int
            if source == "topk_matmul.cu":
                lib.isf_topk_matmul_wgmma.argtypes = [p] * 7 + [i] * 8 + [p]
                lib.isf_topk_matmul_wgmma.restype = i
                lib.isf_topk_matmul_f32_wgmma.argtypes = ([p] * 8 + [i] * 8
                                                          + [p])
                lib.isf_topk_matmul_f32_wgmma.restype = i
            else:
                lib.isf_topk_matmul_int.argtypes = [p] * 11 + [i] * 9 + [p]
                lib.isf_topk_matmul_int.restype = i
            libs[source, form] = lib
        card = cs.card_line()
        print(card, flush=True)
        real_load = _build.load
        if "topk_matmul.cu" in sources:
            enc = libs["topk_matmul.cu", "clocked"].isf_query_map_us
            enc.argtypes = [p, i, i, i, i]
            enc.restype = ctypes.c_double
            for d in (512, 2048):
                q = torch.zeros((1, d), dtype=torch.bfloat16, device="cuda")
                cs.report(card, query_map_us_b1=enc(q.data_ptr(), 1, d, 8,
                                                    10000), d=d)
        gen = torch.Generator(device="cuda").manual_seed(0)
        for dtype in dtypes:
            source = SOURCES[dtype]
            for shape in args.shapes.split(","):
                d, b, k = (int(v) for v in shape.split(":"))
                profile(card, cs, gen, dtype, args.rows, d, b, k,
                        {form: libs[source, form] for form in FORMS},
                        real_load)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


def profile(card, cs, gen, dtype, rows, d, b, k, libs, real_load) -> None:
    """One shape of one store kind through the three forms (see above)."""
    import importlib
    import torch
    from instsearch_torch.kernels import _build
    from instsearch_torch.ops.quantize import (quantize_rows,
                                               quantize_rows_int4)
    # the module (the package re-exports K1's function over its name)
    tm = importlib.import_module("instsearch_torch.kernels.topk_matmul")
    q = cs.unit_rows(gen, b, d, torch.float32)
    if dtype in ("bfloat16", "float32"):
        x = cs.unit_rows(gen, rows, d, getattr(torch, dtype))
        run = lambda: tm.topk_matmul(x, q, k=k)  # noqa: E731
        plan = tm._wg_plan(dtype, rows, d, b, k, x.device)

        def check():
            s, idx = run()
            rs, ri = tm.topk_matmul_reference(x, q, k=k)
            torch.cuda.synchronize()
            tm.check_against_plain(x, q, s, idx, rs, ri, cs.SCORE_TOL)
    else:
        int4 = dtype == "int4"
        quant = quantize_rows_int4 if int4 else quantize_rows
        fn = tm.topk_matmul_int4 if int4 else tm.topk_matmul_int8
        ref = (tm.topk_matmul_int4_reference if int4
               else tm.topk_matmul_int8_reference)
        x = cs.quantized_unit_rows(gen, rows, d, quant)
        run = lambda: fn(x.values, x.scales, q, k=k)  # noqa: E731
        plan = tm._wg_plan(dtype, rows, d, b, k, q.device)

        def check():
            s, idx = run()
            rs, ri = ref(x.values, x.scales, q, k=k)
            torch.cuda.synchronize()
            tm.check_exact(s, idx, rs, ri)
    ms = {form: [] for form in libs}
    for _ in range(2):
        for form, lib in libs.items():
            _build.load = lambda lib=lib: lib
            if form != "products":
                check()
            ms[form].append(cs.cuda_median_ms(run, reps=10))
    clk = (ctypes.c_ulonglong * 8)()
    libs["clocked"].isf_clk_read(clk)      # zero the counters
    _build.load = lambda: libs["clocked"]
    run()
    torch.cuda.synchronize()
    libs["clocked"].isf_clk_read(clk)
    _build.load = real_load
    qb, _, slices = plan
    warps = 8 * slices * -(-b // qb)
    cs.report(card, dtype=dtype, rows=rows, d=d, b=b, k=k, query_block=qb,
              ms=ms, per_consumer_warp={
                  name: clk[j] / warps for j, name in enumerate(COUNTERS)})
    del x
    torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
