#!/usr/bin/env python3
"""``Index.search_range`` on one GPU, one checkout of the port against
another: the A/B runs of a change to the range search.

    python3 tools/range_search_ab.py [--trees LABEL=DIR[,...]]
        [--order LABEL[,...]] [--rows N] [--dim D] [--batches B[,...]]
        [--max-results M] [--reps R]

Each ``LABEL=DIR`` is a checkout of the repo (default: ``change=`` this
one); a parent commit is unpacked with ``git archive`` into a git-ignored
directory for it. ``--order`` runs the labels in turn, each in a process
of its own that imports that checkout's ``instsearch_torch`` (default:
every label, then every label again in reverse, e.g. ``parent,change,
change,parent``). A checkout whose kernel library is not built takes the
one an earlier checkout built from the same sources (the library's name
hashes them), else builds it.

Each run makes phase 15b's single-device store of ``chip_smoke.py``'s
shape (default: 105,133 seeded unit rows of D = 2048 in bf16, Oxford105k's
rows), 25 seeded queries near stored rows, and a threshold at the median
of their 32nd-best scores, and prints one JSON line: for each batch size
B (default 1 and 25) the median of ``--reps`` wall times of
``search_range(q[:B], tau, max_results=M)`` (default M = 256, returning
numpy, so each call ends synchronized), of ``search`` at ``k = M`` (the
members' half: the same K1 call), and the device memory one
``search_range`` call allocated at its peak above what was allocated
before it. Every line carries the card's nvidia-smi name and power
limit.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def _median_ms(fn, reps: int) -> float:
    import torch
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2]


def run_one(label: str, tree: str, args) -> dict:
    """One checkout's measurements (in this process, which imports that
    checkout's package)."""
    sys.path.insert(0, tree)
    import torch
    import instsearch_torch
    from instsearch_torch import IndexConfig, PipelineConfig, SearchConfig
    from instsearch_torch.index import Index
    from instsearch_torch.kernels import _build
    if not instsearch_torch.__file__.startswith(os.path.abspath(tree)):
        raise RuntimeError(f"imported {instsearch_torch.__file__}, not "
                           f"the package of {tree}")
    t0 = time.perf_counter()
    _build.load()
    build_s = time.perf_counter() - t0
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    x = torch.randn((args.rows, args.dim), generator=gen, device="cuda")
    x = torch.nn.functional.normalize(x, dim=1)
    src = torch.randint(0, args.rows, (max(args.batches),), generator=gen,
                        device="cuda")
    q = torch.nn.functional.normalize(
        x[src] + 0.05 * torch.randn((len(src), args.dim), generator=gen,
                                    device="cuda"), dim=1)
    cfg = PipelineConfig(index=IndexConfig(dtype="bfloat16"),
                         search=SearchConfig(k=10))
    idx = Index.from_descriptors(x, [f"r{i}" for i in range(args.rows)],
                                 cfg)
    del x
    torch.cuda.empty_cache()
    one = idx.search(q, cfg.search.replace(k=64))[0]
    tau = float(torch.as_tensor(one[:, 31]).median())
    m = args.max_results
    wide = cfg.search.replace(k=m)
    out = {"tree": label, "card": card_line(), "torch": torch.__version__,
           "rows": args.rows, "dim": args.dim, "dtype": "bfloat16",
           "max_results": m, "tau": tau, "build_s": build_s, "B": {}}
    for b in args.batches:
        qb = q[:b]
        counts = idx.search_range(qb, tau, max_results=m)[2]
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        idx.search_range(qb, tau, max_results=m)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        out["B"][b] = {
            "search_range_ms": _median_ms(
                lambda: idx.search_range(qb, tau, max_results=m), args.reps),
            "search_k_m_ms": _median_ms(lambda: idx.search(qb, wide),
                                        args.reps),
            "peak_gb_above_before": peak / 1e9,
            "count_median": float(sorted(counts)[len(counts) // 2])}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", default=f"change={HERE}")
    ap.add_argument("--order", default=None)
    ap.add_argument("--rows", type=int, default=105_133)
    ap.add_argument("--dim", type=int, default=2048)
    ap.add_argument("--batches", default="1,25")
    ap.add_argument("--max-results", type=int, default=256)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--one", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    args.batches = [int(b) for b in args.batches.split(",")]
    trees = {label: os.path.abspath(d) for label, d in
             (t.split("=", 1) for t in args.trees.split(","))}
    if args.one is not None:
        print(json.dumps(run_one(args.one, trees[args.one], args)),
              flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: this tool measures on the GPU",
              file=sys.stderr)
        return 1
    labels = list(trees)
    order = (args.order.split(",") if args.order
             else labels + labels[::-1])
    rc = 0
    for label in order:
        build = os.path.join(trees[label], "instsearch_torch", "_build")
        for other in trees.values():
            for lib in glob.glob(os.path.join(other, "instsearch_torch",
                                              "_build", "lib*.so")):
                if not os.path.exists(os.path.join(
                        build, os.path.basename(lib))):
                    os.makedirs(build, exist_ok=True)
                    shutil.copy2(lib, build)
        cmd = [sys.executable, os.path.abspath(__file__), "--one", label,
               "--trees", ",".join(f"{k}={v}" for k, v in trees.items()),
               "--rows", str(args.rows), "--dim",
               str(args.dim), "--batches",
               ",".join(map(str, args.batches)), "--max-results",
               str(args.max_results), "--reps", str(args.reps)]
        res = subprocess.run(cmd, capture_output=True, text=True,
                             cwd=trees[label])
        sys.stderr.write(res.stderr[-4000:])
        if res.returncode:
            print(json.dumps({"tree": label, "rc": res.returncode}))
            rc = 1
            continue
        print(res.stdout.strip().splitlines()[-1], flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
