"""Capacity-scale serving walkthrough on the PyTorch port — the deployment
shape for corpora whose exact rows do NOT fit the card (64M×512 int8 =
32 GB): exact rows live in a memory-mapped host file (`HostRowStore`),
only the ~0.5 B/dim PQ codes sit on the card (`IVFPQView`), and a query
reads just its `depth` candidates back from the host for the exact
re-score. The same steps, arguments and printed lines as
``examples/capacity_serving.py``, through ``instsearch_torch``; `python -m
instsearch_torch.cli serve --host-store` wraps step 4 as a daemon. The
IVF-PQ scan is torch operations, as it is XLA operations in the reference:
no hand-written kernel runs here.

Sized to run anywhere in seconds (64k rows); scale N for a real drive.

    python examples/torch_capacity_serving.py                 # the card
    python examples/torch_capacity_serving.py --n 4194304 --adc-only
    python examples/torch_capacity_serving.py --device cpu
"""
import argparse
import json
import os
import tempfile
import time

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=65_536)
    ap.add_argument("--d", type=int, default=128)
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--adc-only", action="store_true",
                    help="rank straight from the on-card ADC scan — no "
                         "host gather (pair with --apq-t)")
    ap.add_argument("--apq-t", type=float, default=0.0,
                    help="anisotropic (score-aware) code fit; lifts "
                         "raw-ADC ranking for --adc-only (ops/pq.py)")
    ap.add_argument("--device", default=None,
                    help="where the work runs: a torch device such as cpu "
                         "or cuda:0 (default: the CUDA card; raises without "
                         "one)")
    args = ap.parse_args(argv)

    from instsearch_torch.search.ivfpq import HostRowStore, IVFPQView
    from instsearch_torch.serve import VectorServeCore
    from instsearch_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    work = args.workdir or tempfile.mkdtemp(prefix="capstore_")

    # ---- 1. write the host store (one-off, any producer) -------------
    # Real deployments stream descriptors out of Index.build / the
    # extractor; random unit rows keep the example self-contained.
    rng = np.random.default_rng(0)
    rows = rng.standard_normal((args.n, args.d)).astype(np.float32)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    t0 = time.time()
    store = HostRowStore.create(os.path.join(work, "store"), rows)
    print(f"store: {args.n}x{args.d} int8 at {work}/store "
          f"({time.time() - t0:.1f}s)")

    # ---- 2. fit the view straight from the memmap --------------------
    # No device-resident Index anywhere: the coarse fit random-reads a
    # row sample, the encode pass streams RAW int8 bytes once.
    t0 = time.time()
    view = IVFPQView.from_host_store(
        store, n_clusters=64, nprobe=8, m=None, depth=100,
        anisotropic_t=args.apq_t or None, device=device)
    print(f"view: {view.n_clusters} buckets, {view.bytes_per_row} B/row, "
          f"scan fraction {view.scan_fraction():.3f} "
          f"({time.time() - t0:.1f}s)")
    view.save(os.path.join(work, "view"))

    # ---- 3. serve: exact cascade vs ADC-only -------------------------
    core = VectorServeCore(store, view, k=5, adc_only=args.adc_only,
                           device=device)
    core.warmup()
    print(json.dumps(core.ready_info()))

    q = rows[7] + 0.03 * rng.standard_normal(args.d).astype(np.float32)
    resp = core.handle_line(json.dumps({"vector": q.tolist(), "k": 3}))
    print(json.dumps(resp))
    assert resp["results"][0][0]["id"] == 7, "self-match must win"

    # ---- 4. the same pair as a daemon ---------------------------------
    print("daemon form:\n  python -m instsearch_torch.cli serve "
          f"--host-store {work}/store --ivfpq-view {work}/view "
          + ("--adc-only" if args.adc_only else ""))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
