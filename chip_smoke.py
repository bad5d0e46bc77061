#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``instsearch_torch``) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card (Hopper,
sm_90a). It builds the port's kernels from ``instsearch_torch/csrc/`` and
runs three phases; each raises on failure and the process exits non-zero.

  0. set-up: the card's name and power limit, the kernel build and its time;
  1. every kernel against its plain PyTorch version on the card, at the
     main path's shapes (1M x 512 rows in bf16 and f32, B in {1, 8, 128},
     k in {1, 10, 100}, D = 2048 at B = 1, padding, a 50% mask, duplicated
     rows, fewer valid rows than k), with kernel and plain medians;
  2. the main path through its entry points: a seeded random ResNet-50 at
     224 px (bf16, GeM, whitening to 512) extracts a corpus of 4096 seeded
     images, the index holds them among seeded unit distractor rows (1M x
     512 bf16 in all), and ``ServeCore`` answers image requests of 1, 3, 8
     and 13 exact copies of corpus images. Every top-1 must be its source;
     the kernel's launch count over this phase must be above zero; the
     plain route must give the same results.

Every measured number is printed with the card's nvidia-smi name and power
limit. The line before the last is the kernel summary as JSON; the last line
is ``{"ok": true, "device": {...}}``. Without CUDA, or outside a checkout,
the script exits non-zero before printing any result.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

N_ROWS = 1 << 20
DIM = 512
CORPUS = 4096
IMAGE = 224
SCORE_TOL = 1e-5        # unit rows: f32 sums in two orders differ far below


def fail(msg: str) -> "None":
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def report(card: str, **fields) -> None:
    print(json.dumps({"card": card, **fields}), flush=True)


def cuda_median_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median of single-call device times (CUDA events) after warm-up."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def phase1(card: str, gen, topk, ref, check) -> tuple[float, dict]:
    """Kernel against plain version; returns (max error, timings). ``check``
    is the kernel's acceptance rule against its plain version
    (``check_against_plain``): scores within SCORE_TOL, the kernel's own
    (score desc, position asc) order, no repeated position, and positions
    equal except at near-ties of distinct rows."""
    import torch
    dev = torch.device("cuda")

    def unit_rows(n, d, dtype):
        x = torch.randn(n, d, generator=gen, device=dev)
        return (x / x.norm(dim=1, keepdim=True)).to(dtype).contiguous()

    def case(x, b, k, label, num_valid=None, mask=None, q=None):
        if q is None:
            q = unit_rows(b, x.shape[1], torch.float32)
        s, i = topk(x, q, k=k, num_valid=num_valid, mask=mask)
        rs, ri = ref(x, q, k=k, num_valid=num_valid, mask=mask)
        torch.cuda.synchronize()
        try:
            err = check(x, q, s, i, rs, ri, SCORE_TOL)
        except AssertionError as e:
            fail(f"{label} B={b} k={k}: {e}")
        if num_valid is not None and int(i.max()) >= num_valid:
            fail(f"{label}: a padding row was returned")
        if mask is not None:
            hit = i[i >= 0].long()
            if not bool((mask.reshape(-1)[hit] > 0).all()):
                fail(f"{label}: a masked-out row was returned")
        report(card, phase=1, case=label, n=x.shape[0], d=x.shape[1], b=b,
               k=k, max_abs_err=err)
        errs.append(err)
        return i

    errs = []
    timings = {}
    nv = N_ROWS - 1000
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[1]
        x = unit_rows(N_ROWS, DIM, dtype)
        for b in (1, 8, 128):
            for k in (1, 10, 100):
                case(x, b, k, f"{name} num_valid=N-1000", num_valid=nv)
        mask = (torch.rand(N_ROWS, generator=gen, device=dev) < 0.5
                ).to(torch.int8)
        case(x, 8, 10, f"{name} 50% mask", mask=mask)
        case(x, 3, 100, f"{name} 50 valid rows < k", num_valid=50)
        if dtype is torch.bfloat16:
            for b in (1, 128):
                q = unit_rows(b, DIM, torch.float32)
                timings[f"bf16 N=1M D=512 B={b} k=10"] = {
                    "ms": cuda_median_ms(lambda: topk(x, q, k=10)),
                    "plain_ms": cuda_median_ms(lambda: ref(x, q, k=10))}
        del x, mask
        # duplicated rows: every score appears 1024 times, so the top 100
        # are the 100 lowest copies of one base row, in position order
        base = unit_rows(1024, DIM, dtype)
        dup = base.repeat(N_ROWS // 1024, 1).contiguous()
        i = case(dup, 8, 100, f"{name} duplicated rows")
        if not (bool((i // 1024 == torch.arange(100, device=dev)).all())
                and bool((i % 1024 == i[:, :1] % 1024).all())):
            fail(f"{name} duplicated rows: copies out of position order")
        del base, dup
        # the unwhitened ResNet-50 width
        x = unit_rows(N_ROWS, 2048, dtype)
        for k in (10, 100):
            case(x, 1, k, f"{name} D=2048", num_valid=nv)
        if dtype is torch.bfloat16:
            q = unit_rows(1, 2048, torch.float32)
            timings["bf16 N=1M D=2048 B=1 k=10"] = {
                "ms": cuda_median_ms(lambda: topk(x, q, k=10)),
                "plain_ms": cuda_median_ms(lambda: ref(x, q, k=10))}
        del x
        torch.cuda.empty_cache()
    for shape, t in timings.items():
        report(card, phase=1, timing=shape, **t)
    return max(errs), timings


def smooth_images(gen, n: int, batch: int = 256):
    """Seeded uint8 [n, S, S, 3] images: low-frequency colour patterns
    (bilinear up-sampled 8x8 noise) plus pixel noise, made on the card."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    out = np.empty((n, IMAGE, IMAGE, 3), np.uint8)
    for s in range(0, n, batch):
        m = min(batch, n - s)
        low = torch.rand(m, 3, 8, 8, generator=gen, device="cuda")
        img = F.interpolate(low, size=(IMAGE, IMAGE), mode="bilinear",
                            align_corners=False)
        img = img + 0.05 * torch.randn(img.shape, generator=gen,
                                       device="cuda")
        img = (img.clamp(0, 1) * 255).round().to(torch.uint8)
        out[s:s + m] = img.permute(0, 2, 3, 1).cpu().numpy()
    return out


def phase2(card: str, gen, topk, check) -> dict:
    import numpy as np
    import torch
    from instsearch_torch import (ExtractConfig, IndexConfig, PipelineConfig,
                                  SearchConfig)
    from instsearch_torch.extractor import Extractor
    from instsearch_torch.index import Index
    from instsearch_torch.ops.whitening import apply_whitening, fit_whitening
    from instsearch_torch.serve import ServeCore

    cfg = PipelineConfig(
        extract=ExtractConfig(backbone="resnet50", pooling="gem", gem_p=3.0,
                              image_size=IMAGE, whiten=True, whiten_dim=DIM,
                              dtype="bfloat16", batch_size=64),
        index=IndexConfig(dtype="bfloat16"), search=SearchConfig(k=10))
    ex = Extractor(cfg.extract.replace(whiten=False), seed=0, device="cuda")
    images = smooth_images(gen, CORPUS)

    # extraction: batches of 64 uint8 images from the host, as Index.build
    ex(images[:64])                                   # cuDNN set-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    raw = torch.cat([ex(images[s:s + 64]) for s in range(0, CORPUS, 64)])
    torch.cuda.synchronize()
    ips = CORPUS / (time.perf_counter() - t0)
    if not bool(torch.isfinite(raw).all()):
        fail("non-finite descriptors")
    report(card, phase=2, extract_images_per_s=ips, batch=64,
           backbone="resnet50", image=IMAGE, dtype="bfloat16")

    ex.whitening = fit_whitening(raw, dim=DIM)
    corpus = apply_whitening(raw, ex.whitening)
    if not bool(torch.isfinite(corpus).all()):
        fail("non-finite whitened descriptors")
    distract = torch.randn(N_ROWS - CORPUS, DIM, generator=gen, device="cuda")
    distract = distract / distract.norm(dim=1, keepdim=True)
    names = ([f"img{i:05d}" for i in range(CORPUS)]
             + [f"distractor{i:07d}" for i in range(N_ROWS - CORPUS)])
    idx = Index.from_descriptors(torch.cat([corpus, distract]), names, cfg,
                                 extractor=ex)
    del distract, raw
    if tuple(idx.descriptors.shape) != (N_ROWS, DIM):
        fail(f"store shape {tuple(idx.descriptors.shape)}")

    core = ServeCore(idx)
    rng = np.random.default_rng(0)
    sizes = (1, 3, 8, 13)
    picks = [rng.choice(CORPUS, size=n, replace=False) for n in sizes]

    core.warmup()
    topk.launches = 0                   # count the served requests' launches
    answers = [core.run_queries([(images[p], 10)])[0] for p in picks]
    launches = topk.launches
    # one launch per bucket piece: a request splits into pieces of the
    # largest bucket, the last one padded
    pieces = sum(-(-n // core.buckets[-1]) for n in sizes)
    if launches != pieces:
        fail(f"the requests launched the topk_matmul kernel {launches} "
             f"times, not once for each of their {pieces} bucket pieces")
    for p, ans in zip(picks, answers):
        top1 = [row[0]["id"] for row in ans["results"]]
        if top1 != p.tolist():
            fail(f"self-retrieval failed: top-1 {top1} for sources "
                 f"{p.tolist()}")
        report(card, phase=2, request_images=len(p), top1_correct=True,
               top1_score_min=min(row[0]["score"] for row in ans["results"]),
               latency_ms=ans["latency_ms"])

    # the plain route on the same store gives the same results
    q = ex(images[np.concatenate(picks)])
    ks, ki = idx.search(q)
    ps, pi = idx.search(q, cfg.search.replace(use_pallas=False))
    positions = torch.arange(N_ROWS, dtype=idx.ids.dtype)
    if not torch.equal(idx.ids.cpu(), positions):
        fail("store ids are not its row positions")
    on_card = [torch.from_numpy(np.asarray(a)).cuda() for a in (ks, ki, ps, pi)]
    try:
        check(idx.descriptors, q, *on_card, SCORE_TOL)
    except AssertionError as e:
        fail(f"kernel and plain route: {e}")
    report(card, phase=2, plain_route_agrees=True, queries=int(ki.shape[0]),
           topk_launches_in_main_path=launches)

    # query latency over the 1M-row store, host clock, synchronized by the
    # results' host copy
    lat = {}
    for b in (1, 128):
        batch = images[rng.choice(CORPUS, size=b, replace=False)]
        qd = ex(batch)
        idx.query_images(batch)                        # warm this shape
        e2e, search = [], []
        for _ in range(20):
            t0 = time.perf_counter()
            idx.query_images(batch)
            e2e.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            idx.search(qd)
            search.append((time.perf_counter() - t0) * 1e3)
        lat[b] = {"query_images_p50_ms": statistics.median(e2e),
                  "search_p50_ms": statistics.median(search)}
        report(card, phase=2, query_batch=b, rows=N_ROWS, **lat[b])
    return {"launches": launches, "latency": lat, "extract_ips": ips}


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke run needs one GPU")
    if not os.path.isdir(os.path.join(HERE, "instsearch_torch")):
        fail("run from a checkout of the repository (instsearch_torch/ "
             "not found beside this script)")
    sys.path.insert(0, HERE)
    from instsearch_torch.kernels import _build
    from instsearch_torch.kernels.topk_matmul import (check_against_plain,
                                                      topk_matmul,
                                                      topk_matmul_reference)

    # phase 0
    card = card_line()
    print(card, flush=True)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    _build.load()
    report(card, phase=0, kernel_build_s=time.perf_counter() - t0,
           library=os.path.relpath(_build.library_path(), HERE))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    err, timings = phase1(card, gen, topk_matmul, topk_matmul_reference,
                          check_against_plain)
    res = phase2(card, gen, topk_matmul, check_against_plain)

    main_shape = timings["bf16 N=1M D=512 B=1 k=10"]
    print(json.dumps({"kernels": [{
        "name": "topk_matmul", "route": "cuda",
        "source": "instsearch_torch/csrc/topk_matmul.cu",
        "replaces": "instsearch_tpu/kernels/topk_matmul.py:608",
        "launches": res["launches"], "max_abs_err": err,
        "ms": main_shape["ms"], "plain_ms": main_shape["plain_ms"]}]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
