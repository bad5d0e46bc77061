#!/usr/bin/env python3
"""The ViT attention kernels, K6 ``mha`` and K5 ``flash_mha``, against
PyTorch's ``scaled_dot_product_attention`` at the shapes the ViT routes
launch, on one GPU.

    python3 tools/attention_sweep.py [--kernels mha,flash_mha]
        [--dtype bfloat16|float32] [--root DIR | --pair PARENT_DIR]

Run from anywhere; the package comes from the checkout this file lies in,
or from ``--root``. For each shape, q, k and v are bf16 (with ``--dtype
float32``: f32, the kernels' CUDA-core forms ``mha_kernel_f32`` and
``flash_kernel_f32`` at their own shapes, SDPA with TF32 off) views of one
seeded packed ``[B, N, 3, h, hd]`` projection, as the model passes them; the
kernel's answer is first held to its plain version by ``check_attention``,
then one JSON line gives the CUDA-event medians (after warm-up) of single
calls of the kernel's wrapper (``ms``, as ``chip_smoke.py`` times it), of
its plain version (``plain_ms``) and of SDPA on the same tensors
(``sdpa_ms``), the device time per call of the kernel and of SDPA under
``torch.profiler`` (``device_ms``, ``sdpa_device_ms``; the call less its
device time is ``host_ms``), and the least time the card could take
(``chip_smoke.bound``). Every line carries the card's nvidia-smi name and
power limit.

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

# (kernel, [B, h, N, hd]): K6 at 224 px (B = 1, the extraction batch of 64
# and 128; ViT-L/16's 16 heads) and 1024 px; K5 at 1024 px (B = 1 and the
# route's batch of 4) and 2048 px
SHAPES = [("mha", (1, 12, 197, 64)), ("mha", (64, 12, 197, 64)),
          ("mha", (64, 16, 197, 64)), ("mha", (128, 12, 197, 64)),
          ("mha", (1, 12, 4097, 64)),
          ("flash_mha", (1, 12, 4097, 64)), ("flash_mha", (4, 12, 4097, 64)),
          ("flash_mha", (1, 12, 16385, 64))]
# in f32: K6 at phase 1's batch and the extraction batch of 64 (its f32
# form keeps 16 rows of logits, so no 4,097 tokens), K5 at phase 1's
# [2, 12, 1025, 64] and at 1024 px
SHAPES_F32 = [("mha", (8, 12, 197, 64)), ("mha", (64, 12, 197, 64)),
              ("flash_mha", (2, 12, 1025, 64)),
              ("flash_mha", (1, 12, 4097, 64))]


def _chip_smoke():
    """This checkout's ``chip_smoke`` (its timing helpers), whatever
    ``--root`` is."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def device_ms(fn, name: str, reps: int = 10) -> float:
    """Device time per call of ``fn`` by torch.profiler: the kernels whose
    name holds ``name`` (a CUDA kernel's symbol, or SDPA's ``flash`` /
    ``fmha``); every device operation when ``name`` is empty."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(e.time_range.elapsed_us() for e in prof.events()
                if e.device_type == DeviceType.CUDA and name in e.name)
    if not total:
        raise RuntimeError(f"the profiler recorded no kernel named *{name}*")
    return total / 1e3 / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels", default="mha,flash_mha",
                    help="comma-separated, of mha and flash_mha")
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("bfloat16", "float32"))
    ap.add_argument("--root", default=HERE,
                    help="checkout whose instsearch_torch is timed")
    ap.add_argument("--pair", metavar="PARENT_DIR",
                    help="run parent, this, this, parent, one process each")
    ap.add_argument("--tree", default="", help=argparse.SUPPRESS)
    ap.add_argument("--run", type=int, default=0, help=argparse.SUPPRESS)
    args = ap.parse_args()
    kernels = args.kernels.split(",")
    if not set(kernels) <= {"mha", "flash_mha"}:
        ap.error("--kernels: mha and/or flash_mha")
    if args.pair:
        rc = 0
        for run, (tree, root) in enumerate((("parent", args.pair),
                                            ("change", HERE),
                                            ("change", HERE),
                                            ("parent", args.pair))):
            rc |= subprocess.run(
                [sys.executable, os.path.abspath(__file__),
                 f"--kernels={args.kernels}", f"--dtype={args.dtype}",
                 f"--root={os.path.abspath(root)}", f"--tree={tree}",
                 f"--run={run}"]).returncode
        return rc
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("attention_sweep: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    torch.backends.cuda.matmul.allow_tf32 = False
    from instsearch_torch.kernels import vit_attention as va
    cs = _chip_smoke()
    card = cs.card_line()
    print(card, flush=True)
    tags = {"tree": args.tree, "run": args.run} if args.tree else {}
    gen = torch.Generator(device="cuda").manual_seed(0)
    dtype = getattr(torch, args.dtype)
    f32 = dtype is torch.float32
    for name, (b, h, n, hd) in SHAPES_F32 if f32 else SHAPES:
        if name not in kernels:
            continue
        fn = getattr(va, name)
        ref = getattr(va, f"{name}_reference")
        qkv = torch.randn((b, n, 3, h, hd), generator=gen,
                          device="cuda").to(dtype)
        q, k, v = (t.transpose(1, 2) for t in qkv.unbind(2))
        err = va.check_attention(fn(q, k, v), ref(q, k, v))
        long = n > 2000
        ms = cs.cuda_median_ms(lambda: fn(q, k, v), reps=5 if long else 20)
        dev = device_ms(lambda: fn(q, k, v), name.replace("_mha", ""))
        sdpa = lambda: F.scaled_dot_product_attention(q, k, v)  # noqa: E731
        cs.report(card, **tags, kernel=name, dtype=args.dtype,
                  shape=[b, h, n, hd],
                  rel_err=err["rel_err"], ms=ms, device_ms=dev,
                  host_ms=ms - dev,
                  plain_ms=cs.cuda_median_ms(lambda: ref(q, k, v),
                                             reps=3 if long else 10,
                                             warmup=1),
                  sdpa_ms=cs.cuda_median_ms(sdpa, reps=5 if long else 20),
                  sdpa_device_ms=device_ms(sdpa, ""),
                  **cs.bound(4 * b * h * n * hd * q.element_size(),
                             4 * b * h * n * n * hd,
                             "f32" if f32 else "bf16"))
        del q, k, v, qkv
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
