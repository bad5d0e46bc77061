#!/usr/bin/env python3
"""Search p50 of the PQ cascade of ``configs/capacity_int4.json`` on one GPU:
chip_smoke.py phase 4's store without the backbone.

    python3 tools/pq_search.py [--rows 1048576] [--batches 1,8,128]
                               [--reps 20] [--root DIR | --pair PARENT_DIR]

Run from anywhere; the package comes from the checkout this file lies in,
or from ``--root``. It stores ``--rows`` seeded unit rows (the preset's
width, 512) as the preset's int4 store with alpha query expansion, builds
the PQ view with the reference's defaults (``Index.build_pq()``: M = 64,
15 iterations, depth 100; seeded), and for each query batch B prints one
JSON line with the host-clock median of ``Index.search`` over ``--reps``
calls (``search_p50_ms``; each call ends in the results' host copy), the
device time per call under ``torch.profiler`` (``busy_ms``), its K4 share
(``pq_topk_ms``: kernels named ``pq_*``, K4's pass 1 of the older design,
``topk_pass1<PQRows, ...>``, and pass 2) and the K4 launches per call.
The queries are stored rows with noise, so the cascade finds them. Every
line carries the card's nvidia-smi name and power limit.

``--pair PARENT_DIR`` compares two trees on one card as
``tools/topk_sweep.py --pair`` does: PARENT_DIR, this checkout, this
checkout, PARENT_DIR, one process each, lines tagged ``tree`` and ``run``.
"""
from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _is_k4(name: str) -> bool:
    # no other top-k kernel runs in this search, so pass 2 is K4's
    return "pq_" in name or "PQRows" in name or "topk_pass2" in name


def run(rows: int, batches, reps: int, tags: dict) -> None:
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from instsearch_torch import PipelineConfig
    from instsearch_torch.index import Index
    from instsearch_torch.kernels import pq_topk
    cs = _chip_smoke()
    card = cs.card_line()
    cfg = PipelineConfig.load(os.path.join(HERE, "configs",
                                           "capacity_int4.json"))
    gen = torch.Generator(device="cuda").manual_seed(0)
    dim = cfg.extract.whiten_dim
    x = cs.unit_rows(gen, rows, dim, torch.float32)
    names = [f"row{i:07d}" for i in range(rows)]
    idx = Index.from_descriptors(x, names, cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    idx.build_pq()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    for b in batches:
        src = torch.as_tensor(rng.choice(rows, size=b, replace=False),
                              device="cuda")
        q = x[src] + 0.05 * cs.unit_rows(gen, b, dim, torch.float32)
        q = q / q.norm(dim=1, keepdim=True)
        _, ids = idx.search(q)                       # warm this shape
        hits = float(np.mean(np.asarray(ids)[:, 0]
                             == np.asarray(src.cpu())))
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            idx.search(q)
            times.append((time.perf_counter() - t0) * 1e3)
        before = pq_topk.launches
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                idx.search(q)
            torch.cuda.synchronize()
        launches = (pq_topk.launches - before) / reps
        busy = k4 = 0.0
        for e in prof.events():
            if e.device_type != DeviceType.CUDA:
                continue
            us = e.time_range.elapsed_us()
            busy += us
            k4 += us if _is_k4(e.name) else 0.0
        cs.report(card, **tags, config="configs/capacity_int4.json",
                  store="int4 + PQ", rows=rows, b=b, k=cfg.search.k,
                  pq_depth=idx.cfg.search.pq_depth, build_pq_s=build_s,
                  top1_is_source=hits,
                  search_p50_ms=statistics.median(times),
                  busy_ms=busy / 1e3 / reps, pq_topk_ms=k4 / 1e3 / reps,
                  pq_topk_launches=launches)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=1 << 20)
    ap.add_argument("--batches", default="1,8,128")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--root", default=HERE,
                    help="checkout whose instsearch_torch is timed")
    ap.add_argument("--pair", metavar="PARENT_DIR",
                    help="run parent, this, this, parent, one process each")
    ap.add_argument("--tree", default="", help=argparse.SUPPRESS)
    ap.add_argument("--run", type=int, default=0, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.pair:
        rc = 0
        for run_no, (tree, root) in enumerate((("parent", args.pair),
                                               ("change", HERE),
                                               ("change", HERE),
                                               ("parent", args.pair))):
            rc |= subprocess.run(
                [sys.executable, os.path.abspath(__file__),
                 f"--rows={args.rows}", f"--batches={args.batches}",
                 f"--reps={args.reps}", f"--root={os.path.abspath(root)}",
                 f"--tree={tree}", f"--run={run_no}"]).returncode
        return rc
    import torch
    if not torch.cuda.is_available():
        print("pq_search: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    tags = {"tree": args.tree, "run": args.run} if args.tree else {}
    run(args.rows, [int(v) for v in args.batches.split(",")], args.reps,
        tags)
    return 0


if __name__ == "__main__":
    sys.exit(main())
