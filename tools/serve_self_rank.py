#!/usr/bin/env python3
"""Where a served image ranks its own row, on phase 13's index (workload 1:
ResNet-50 at 224 px, bf16 store, random weights from the seed, seeded
grating JPEG files), on one GPU.

    python3 tools/serve_self_rank.py [--images N] [--seed S] [--serve R]

Builds the index with ``cli build-index`` as ``chip_smoke.py`` phase 13
does, then prints JSON lines, each with the card's nvidia-smi name and
power limit:

* ``rows``: the stored rows' norms (bf16 rows of a unit descriptor whose
  components are themselves scaled bf16 values round mostly one way);
* ``batch``: for extraction batches of 1, 2, 4, 8 and 64 (the serve
  buckets and the build's batch), the cosine of each image's descriptor
  to its stored row, and the rank of its own row among all rows under
  the bf16-rounded query (the search's operands) with the self-scores:
  how many sources trail a neighbour, how many trail more than 5 (a
  served top-5 misses them), and how many of those lie within
  ``chip_smoke.BF16_TIE`` of the first;
* ``kernel``: K1 (``topk_matmul``) over the stored rows, the stored rows
  as queries in random groups of B = 1 to 8, k = 10, against the plain
  top-10 of the same operands: slots whose position differs beyond a
  near-tie;
* ``serve`` (``--serve R``): ``chip_smoke.serve_tcp_clients`` R times on
  the index (1 and 8 clients of 64 requests; a failure is printed, not
  raised).
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--images", type=int, default=5063)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--serve", type=int, default=0)
    args = p.parse_args()

    import numpy as np
    import torch

    import chip_smoke as cs
    card = cs.card_line()

    def out(**fields):
        print(json.dumps({"card": card, **fields}), flush=True)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    tmp = tempfile.mkdtemp(prefix="serve_self_rank_")
    try:
        images = os.path.join(tmp, "images")
        paths = cs.write_jpegs(gen, images, args.images)
        names = [os.path.splitext(os.path.basename(q))[0] for q in paths]
        plain = os.path.join(tmp, "plain")
        cs.run_cli("build-index", "--images", images, "--out", plain,
                   "--config", cs.WORKLOAD1)
        from instsearch_torch.data import frontend, native_frontend
        from instsearch_torch.index import Index
        from instsearch_torch.kernels.topk_matmul import (
            topk_matmul, topk_matmul_reference)
        idx = Index.load(plain, device="cuda")
        n = len(idx.names)
        if list(idx.names) != names:
            raise SystemExit("the index's rows are not in file order")
        store = idx.descriptors[:n]
        x = store.float()
        norms = x.norm(dim=1)
        out(part="rows", n=n, dtype=str(store.dtype),
            native_decoder=native_frontend.available(),
            norm_min=float(norms.min()), norm_max=float(norms.max()))

        imgs = np.stack([frontend.load_square(q, idx.cfg.extract.image_size)
                         for q in paths])
        every = torch.arange(n, device="cuda")
        for b in (1, 2, 4, 8, 64):
            qs = []
            for s in range(0, n, b):
                piece = imgs[s:s + b]
                if len(piece) < b:      # padded as the server pads
                    piece = np.concatenate(
                        [piece, np.repeat(piece[-1:], b - len(piece), 0)])
                qs.append(idx.extractor(piece)[:min(b, n - s)].float())
            q = torch.cat(qs)
            cos = (q * x).sum(1) / norms / q.norm(dim=1)
            scores = q.to(store.dtype).float() @ x.T
            own = scores[every, every]
            rank = (scores > own[:, None]).sum(1)
            gap = scores.max(1).values - own
            past5 = rank >= 5
            out(part="batch", b=b, cos_min=float(cos.min()),
                cos_median=float(cos.median()),
                self_score_min=float(own.min()),
                self_score_max=float(own.max()),
                trailing=int((rank > 0).sum()), rank_max=int(rank.max()),
                past_top5=int(past5.sum()),
                past_top5_within_tie=int(
                    (past5 & (gap <= cs.BF16_TIE)).sum()),
                gap_max=float(gap.max()))

        k = 10
        bad = calls = 0
        order = torch.randperm(n, generator=torch.Generator().manual_seed(1))
        for b in range(1, 9):
            for s in range(0, n - b + 1, b):
                g = order[s:s + b].cuda()
                got_s, got_i = topk_matmul(store, store[g], k=k)
                ref_s, ref_i = topk_matmul_reference(store, store[g], k=k)
                same = got_i == ref_i
                near = (got_s - ref_s).abs() <= 1e-5
                bad += int((~same & ~near).sum())
                calls += 1
        out(part="kernel", calls=calls, k=k, slots_off=bad,
            launches=topk_matmul.launches)

        for r in range(args.serve):
            try:
                stats = cs.serve_tcp_clients(card, plain, paths, names,
                                             np.random.default_rng(13 + r))
                out(part="serve", run=r, ok=True, stats=stats)
            except SystemExit:
                out(part="serve", run=r, ok=False)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
