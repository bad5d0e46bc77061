#!/usr/bin/env python3
"""Where K6's bf16 kernel (``instsearch_torch/csrc/vit_attention.cu``)
spends its time, on one GPU.

    python3 tools/k6_profile.py [--root DIR] [--shapes 64:12:197,1:12:4097]
        [--removals]

Builds forms of ROOT's ``vit_attention.cu`` (ROOT: this checkout, or
``--root``, e.g. ``git archive`` of the parent commit unpacked into a
git-ignored folder), each into a scratch folder of its own under the
system's temporary directory (the package's build is untouched), and times
them through ROOT's ``mha`` wrapper on q, k, v views of one seeded packed
``[B, N, 3, h, 64]`` bf16 projection, the forms in turn, twice each:
  * ``kernel``: the source as it is (every answer first held to the plain
    version by ``check_attention``);
  * ``two_pass`` (the TMA + wgmma kernel only): form (b) at N <= 256, two
    passes over the resident key boxes (QK^T twice, the rows' max and sum
    online in the first, the steps of the kernel's ring past 256 tokens) in
    place of form (a)'s one pass over the whole rows in registers;
  * ``clocked``: the kernel with ``clock64()`` counters per consumer warp,
    summed over the warps of one call: cycles waiting for loads (the TMA
    kernel: its mbarrier waits for an item's q and K, its V, a q tile or a
    ring stage; the
    ``mma.sync`` kernel of earlier trees: its cp.async waits and the block
    syncs after them), in the products (issued to waited for, both), in
    the stores of o, and in all; the rest of ``all`` is the softmax (and
    the issue of the ``mma.sync`` kernel's copies);
  * with ``--removals`` (the TMA kernel, N <= 256), the forms of
    ``removal_forms``: one part changed or taken out.
Each shape prints one JSON line with the card's nvidia-smi name and power
limit: per form the CUDA-event medians of single wrapper calls (``ms``)
and the device time per call under torch.profiler (``device_ms``), and the
``clocked`` form's counters per consumer warp with their shares of
``all``. The forms are made by editing the kernel's source; a line that is
no longer there stops the tool with its text.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import os
import re
import shutil
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = "64:12:197,64:16:197,1:12:4097"
COUNTERS = ("wait", "products", "store", "all")
REMOVED = ("no_softmax", "no_stores", "loads_only")   # wrong answers
# per-lane counters in shared memory (each lane adds its own cycles to its
# own slot: no atomic, no branch beside the products), flushed to the
# global sums at the end
PRELUDE = """
__device__ unsigned long long isf_clk[4];
__shared__ unsigned long long isf_clk_s[16][4][32];
#define ISF_T0 const long long isf_t0 = clock64();
#define ISF_ADD(i) isf_clk_s[threadIdx.x / 32][i][threadIdx.x % 32] += \\
    (unsigned long long)(clock64() - isf_t0);
"""
READ_CLOCKS = """
extern "C" void isf_clk_read(unsigned long long* out) {
  const unsigned long long zero[4] = {0, 0, 0, 0};
  cudaMemcpyFromSymbol(out, isf_clk, sizeof(zero));
  cudaMemcpyToSymbol(isf_clk, zero, sizeof(zero));
}
"""
FLUSH = """  for (int i = 0; i < 4; ++i)
    atomicAdd(isf_clk + i, isf_clk_s[threadIdx.x / 32][i][threadIdx.x % 32]);
"""
ZERO = """  for (int i = threadIdx.x; i < 16 * 4 * 32; i += blockDim.x)
    (&isf_clk_s[0][0][0])[i] = 0;
"""


def _need(text: str, line: str) -> None:
    if line not in text:
        raise SystemExit(f"k6_profile: the kernel no longer has the "
                         f"line\n{line}")


def _span(text: str, start: str) -> tuple[int, int]:
    """[begin, end) of the function whose text starts at ``start``: up to
    the first line that is a lone closing brace."""
    _need(text, start)
    a = text.index(start)
    return a, text.index("\n}\n", a) + 3


def _wrap(body: str, pattern: str, counter: int) -> str:
    out, n = re.subn(pattern, lambda m: "{ ISF_T0 " + m.group(0)
                     + f" ISF_ADD({counter}) }}", body)
    if not n:
        raise SystemExit(f"k6_profile: no statement matches {pattern}")
    return out


def clocked_tma(text: str) -> str:
    """The TMA + wgmma kernel (mha_kernel_tma and its helpers) with the
    counters."""
    first = "// K6 in bf16 (mha_kernel_tma)"
    _need(text, first)
    a = text.index(first)
    b, e = _span(text, "template <int KT>\n__global__ void __launch_bounds__"
                 "(3 * 128, 1)\n    mha_kernel_tma(")
    helpers, kernel = text[a:b], text[b:e]
    helpers = _wrap(helpers, r"mha_logits<\w+>\([^;]*\);", 1)
    helpers = _wrap(helpers, r"mha_pv<\w+>\([^;]*\);", 1)
    helpers = _wrap(helpers, r"hopper::mbar_wait\(vfull, phase\);", 0)
    kernel = _wrap(kernel, r"mbar_wait\(&sm\.(q_)?full\[[^;]*\);", 0)
    kernel = _wrap(kernel, r"mha_store\([^;]*\);", 2)
    start = "  int it = 0, load = 0;\n  for (int item"
    _need(kernel, start)
    kernel = kernel.replace(
        start, "  const long long isf_start = clock64();\n" + start)
    init = "  __syncthreads();\n\n  if (threadIdx.x >= 2 * 128) {"
    _need(kernel, init)
    kernel = kernel.replace(init, ZERO + init)
    assert kernel.endswith("\n}\n")
    kernel = kernel[:-2] + ("  isf_clk_s[threadIdx.x / 32][3]"
                            "[threadIdx.x % 32] = clock64() - isf_start;\n"
                            + FLUSH + "}\n")
    return text[:a] + PRELUDE + helpers + kernel + text[e:]


def clocked_mma(text: str) -> str:
    """The mma.sync kernel of earlier trees (mha_kernel_mma) with the
    counters."""
    a, e = _span(text, "__global__ void __launch_bounds__(kThreads)\n"
                 "    mha_kernel_mma(")
    k = text[a:e]
    k = _wrap(k, r"cp_async_wait<\d>\(\);", 0)
    k = _wrap(k, r"__syncthreads\(\);", 0)
    k = _wrap(k, r"logits_tile\([^;]*\);", 1)
    pv = "    const bf16* vt = vs + (j & 1) * kTile;\n"
    _need(k, pv)
    k = k.replace(pv, "    { ISF_T0\n" + pv)
    end_pv = ("        mma_bf16(acc[d + 1], pa, vb[2], vb[3]);\n"
              "      }\n    }\n")
    _need(k, end_pv)
    k = k.replace(end_pv, end_pv + "    ISF_ADD(1) }\n")
    store = "  const size_t obase = head_base(out, heads);\n"
    _need(k, store)
    k = k.replace(store, "  { ISF_T0\n" + store)
    assert k.endswith("  }\n}\n")
    k = k[:-2] + ("  ISF_ADD(2) }\n"
                  "  isf_clk_s[threadIdx.x / 32][3][threadIdx.x % 32] = "
                  "clock64() - isf_start;\n" + FLUSH + "}\n")
    begin = "  extern __shared__ float4 smem4[];\n  constexpr int kTile"
    _need(k, begin)
    k = k.replace(begin, "  const long long isf_start = clock64();\n"
                  + ZERO + "  __syncthreads();\n" + begin)
    return text[:a] + PRELUDE + k + text[e:]


# Form (b) at N <= 256: two passes over the resident key boxes with the
# ring's per-box steps (mha_stats, mha_pass2), V waited for before pass 2
TWO_PASS = """// Form (b) for 64 query rows over KT resident boxes.
template <int KT>
__device__ __forceinline__ void mha_two_pass(float (&acc)[kHd / 2],
                                             uint64_t dq, const bf16* kb,
                                             const bf16* vb, uint64_t* vfull,
                                             uint32_t phase, int c, int n,
                                             float scale2) {
  float m2[2] = {kFlashNeg, kFlashNeg}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int x = 0; x < KT; ++x) {
    float sc[1][64];
    mha_logits<1>(sc, dq, kb + x * kMhaBoxElems);
    mha_mask(sc[0], x * kMhaBox, c, n);
    mha_stats(sc, m2, l, scale2);
  }
  const float inv[2] = {1.f / quad_sum(l[0]), 1.f / quad_sum(l[1])};
#pragma unroll
  for (int i = 0; i < kHd / 2; ++i) acc[i] = 0.f;
  hopper::mbar_wait(vfull, phase);
#pragma unroll
  for (int x = 0; x < KT; ++x) {
    float sc[1][64];
    mha_logits<1>(sc, dq, kb + x * kMhaBoxElems);
    mha_mask(sc[0], x * kMhaBox, c, n);
    mha_pass2(acc, sc, m2, inv, vb + x * kMhaBoxElems, scale2);
  }
}

"""
KERNEL = ("template <int KT>\n__global__ void __launch_bounds__(3 * 128, 1)\n"
          "    mha_kernel_tma(")
ONE_PASS_CALL = "        mha_one_pass<KT>("


SOFTMAX = ("  mha_mask(sc[KT - 1], c0, c, n);\n", "  uint32_t pa[KT][32];\n")
STORE = "        mha_store(to, qt, wg, t, rowt, c, 64 * st, head, batch, acc);\n"
# the accumulator summed into one word that is never true, so that the
# compiler keeps the products whose stores a removal form takes out
SINK = """        { float s_ = 0.f;
          for (int i = 0; i < kHd / 2; ++i) s_ += acc[i];
          if (s_ == 1e30f) mha_store(to, qt, wg, t, rowt, c, 0, 0, 0, acc); }
"""
SUBTILES = ("      for (int st = wg; st < 2 * KT && 64 * st < n; st += 2) {\n",
            "      if (t == 0) bulk_wait_read<0>();\n")
V_WAIT = "      mbar_wait(&sm.full[b], (it >> 1) & 1);\n"


def removal_forms(text: str) -> dict:
    """The TMA kernel with one part changed or taken out, at N <= 256: the
    non-ftz exp2f for ex2.approx.ftz (``exp2f``); V waited for with q and K
    (``v_with_qk``); no softmax, p = S (``no_softmax``); no stores of o
    (``no_stores``); the consumers only waiting for each item's loads, V's
    too, so that no barrier is armed again before its phase completes
    (``loads_only``). Their answers are wrong but for ``exp2f`` and
    ``v_with_qk``; they are timed, not checked."""
    for line in (*SOFTMAX, STORE, *SUBTILES, V_WAIT, KERNEL):
        _need(text, line)
    a = text.index("// K6 in bf16 (mha_kernel_tma)")
    b = text.index(KERNEL)
    exp2f = text[:a] + text[a:b].replace("ex2_ftz(", "exp2f(") + text[b:]
    i, j = text.index(SOFTMAX[0]), text.index(SOFTMAX[1])
    no_softmax = (text[:i] + "  const float inv[2] = {1.f, 1.f};\n"
                  + text[j:])
    i = text.index(SUBTILES[0])
    j = text.index(SUBTILES[1], i)
    return {"exp2f": exp2f,
            "v_with_qk": text.replace(V_WAIT, V_WAIT + V_WAIT.replace(
                "sm.full", "sm.vfull")),
            "no_softmax": no_softmax,
            "no_stores": text.replace(STORE, SINK),
            "loads_only": text[:i] + V_WAIT.replace("sm.full", "sm.vfull")
                          + text[j:]}


def forms(text: str, removals: bool = False) -> dict:
    if "mha_kernel_tma(" in text:
        for line in (KERNEL, ONE_PASS_CALL):
            _need(text, line)
        two = text.replace(KERNEL, TWO_PASS + KERNEL).replace(
            ONE_PASS_CALL, "        mha_two_pass<KT>(")
        return {"kernel": text, "two_pass": two,
                "clocked": clocked_tma(text),
                **(removal_forms(text) if removals else {})}
    return {"kernel": text, "clocked": clocked_mma(text)}


def build(root: str, form: str, text: str, tmp: str) -> subprocess.Popen:
    """ROOT's sources into tmp/form with vit_attention.cu as `text`; starts
    nvcc on it alone (the library is tmp/form/lib.so)."""
    from instsearch_torch.kernels import _build
    src = os.path.join(tmp, form)
    shutil.copytree(os.path.join(root, "instsearch_torch", "csrc"), src)
    with open(os.path.join(src, "vit_attention.cu"), "w") as f:
        f.write(text + (READ_CLOCKS if form == "clocked" else ""))
    return subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
         os.path.join(src, "lib.so"), os.path.join(src, "vit_attention.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def consumer_warps(tma: bool, b: int, h: int, n: int, sms: int) -> int:
    """Consumer warps of one call: the TMA kernel's persistent blocks (8
    each), or the mma.sync kernel's blocks of 64 query rows (4 each)."""
    if not tma:
        return 4 * b * h * -(-n // 64)
    items = b * h * (1 if n <= 256 else -(-n // 128))
    return 8 * min(items, sms)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE,
                    help="checkout whose vit_attention.cu and mha are timed")
    ap.add_argument("--shapes", default=SHAPES, help="B:h:N,...")
    ap.add_argument("--removals", action="store_true",
                    help="also time the removal forms (the TMA kernel)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("k6_profile: needs a CUDA device", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    with open(os.path.join(root, "instsearch_torch", "csrc",
                           "vit_attention.cu")) as f:
        text = f.read()
    variants = forms(text, args.removals)
    tma = "two_pass" in variants
    cs = _chip_smoke()
    sys.path.insert(0, HERE)
    from tools.attention_sweep import device_ms
    sys.path.insert(0, root)
    for name in [m for m in sys.modules if m.startswith("instsearch_torch")]:
        del sys.modules[name]
    from instsearch_torch.kernels import _build
    from instsearch_torch.kernels import vit_attention as va
    tmp = tempfile.mkdtemp(prefix="k6_profile_")
    try:
        procs = {form: build(root, form, src, tmp)
                 for form, src in variants.items()}
        libs = {}
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        for form, proc in procs.items():
            out = proc.communicate()[0]
            if proc.returncode:
                print(out[-4000:], file=sys.stderr)
                return 1
            lib = ctypes.CDLL(os.path.join(tmp, form, "lib.so"))
            lib.isf_mha.argtypes = [p, p, p, p, i, i, i, i, i,
                                    ll, ll, ll, ll, ll, ll, p]
            lib.isf_mha.restype = i
            lib.isf_mha_smem.argtypes = [i, i]
            lib.isf_mha_smem.restype = ll
            libs[form] = lib
        card = cs.card_line()
        print(card, flush=True)
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        gen = torch.Generator(device="cuda").manual_seed(0)
        for shape in args.shapes.split(","):
            b, h, n = (int(v) for v in shape.split(":"))
            qkv = torch.randn((b, n, 3, h, 64), generator=gen,
                              device="cuda").to(torch.bfloat16)
            q, k, v = (t.transpose(1, 2) for t in qkv.unbind(2))
            want = va.mha_reference(q, k, v)
            ms = {form: [] for form in libs}
            dev = {form: [] for form in libs}
            for _ in range(2):
                for form, lib in libs.items():
                    _build.load = lambda lib=lib: lib
                    out = va.mha(q, k, v)
                    if form not in REMOVED:
                        va.check_attention(out, want)
                    ms[form].append(cs.cuda_median_ms(
                        lambda: va.mha(q, k, v)))
                    dev[form].append(device_ms(lambda: va.mha(q, k, v),
                                               "mha_kernel"))
            clk = (ctypes.c_ulonglong * 4)()
            libs["clocked"].isf_clk_read(clk)      # zero the counters
            _build.load = lambda: libs["clocked"]
            va.mha(q, k, v)
            torch.cuda.synchronize()
            libs["clocked"].isf_clk_read(clk)
            warps = consumer_warps(tma, b, h, n, sms)
            per_warp = {c: clk[j] / warps / 32
                        for j, c in enumerate(COUNTERS)}
            share = {c: per_warp[c] / per_warp["all"] for c in COUNTERS[:3]}
            share["softmax_and_other"] = 1 - sum(share.values())
            cs.report(card, root=os.path.relpath(root, HERE), b=b, h=h, n=n,
                      kernel="mha_kernel_tma" if tma else "mha_kernel_mma",
                      ms=ms, device_ms=dev, consumer_warps=warps,
                      per_consumer_warp=per_warp, share=share)
            del q, k, v, qkv, want
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
