"""Benchmark harness (port of ``instsearch_tpu/bench.py``): timed stages of
the port's own code paths, with the reference's stage names, arguments,
defaults and returned keys, behind ``cli bench``.

Timing method. Every stage runs its operation chained ``n1`` and ``n2``
times and reports the marginal cost of one more call,

    per_op = (t(chain_n2) - t(chain_n1)) / (n2 - n1),

which cancels the fixed cost a chain pays once (the first launch, the last
synchronize, the host's gap before the card starts). Short and long chains
run interleaved, rep by rep; the short chain's median anchors each long
rep's estimate, the long reps give the spread, and an estimate is clamped
at 1e-9 s. On the card a chain is timed by a pair of CUDA events on the
current stream, with one synchronize after the end event; on the CPU by
``time.perf_counter``. A chain whose calls synchronize with the host inside
(``bench_train``: ``Trainer.step`` reads its loss) is timed by the host's
clock around a synchronize (``wall=True``). ``bench_dba``,
``bench_extraction_e2e``, ``bench_host_serve`` and ``bench_protocol_eval``
time host work by the host's clock, each call fenced, as the reference does.

The port runs eagerly, and so is it timed: nothing is captured in a CUDA
graph and nothing is compiled, so the host's launch time of every
operation is part of what a stage reports. The reference threads a
``acc * 1e-30`` dependency through its chains so that XLA can neither
merge nor reorder the unrolled calls; eager calls on one stream run in
launch order and are never merged, so a chain here is the calls alone.

The roofline is measured on the card, not taken from a datasheet:
``make_stream_probe`` is a chained bf16 matrix-vector product over the same
matrix (``torch.matmul``), and ``bench_query`` runs it rep for rep beside
the kernel (``interleaved_marginal``), so drift of the card's clock is
common to both and the paired ratio is honest. ``frac_of_roofline`` is the
kernel's time against the probe's streaming rate for the kernel's bytes.

Data is drawn where the reference draws it: stores and queries the
reference makes with ``jax.random`` are made on the device from a
``torch.Generator`` seeded as the reference's key (the same distributions,
not the same numbers); what it draws with numpy is drawn with numpy, the
same numbers. Every stage takes ``device`` (default: the CUDA card,
raising without one; the CPU only when asked). ``path`` names the route a
query took: ``"kernel"``, ``"kernel-int8"``, ``"kernel-int4"`` (the
hand-written kernels, on the card), ``"plain"`` (a CPU run: their plain
versions or the scoring oracle) and ``"torch"`` (``use_pallas=False`` on
the card: ``search/bruteforce.py::search_topk``, the yardstick).
"""
from __future__ import annotations

import gc
import json
import math
import os
import sys
import time

import numpy as np
import torch

from .config import ExtractConfig
from .extractor import build_extract_fn
from .utils.device import resolve_device


def _chain_seconds(f, args, device: torch.device, wall: bool) -> float:
    """Seconds of one call of the chain ``f(*args)``: CUDA events on the
    current stream around it on the card (unless ``wall``), else the host's
    clock, fenced by a synchronize on the card."""
    if device.type == "cuda" and not wall:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        f(*args)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    f(*args)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter() - t0


def _warm(fns, device: torch.device) -> None:
    """Run each ``(f, args)`` once (kernel build, plans, the caching
    allocator), then wait for the card."""
    for f, a in fns:
        f(*a)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def marginal_times(make_chained, args, n1: int = 3, n2: int = 13,
                   reps: int = 7, *, device=None, wall: bool = False
                   ) -> np.ndarray:
    """Per-rep marginal per-op estimates from two chain lengths.

    ``make_chained(n)`` returns a function running the op n times.
    Estimate_i = (t2_i - median(t1)) / (n2 - n1): the short-chain median
    anchors the fixed cost, the long-chain reps give the spread. Short and
    long reps are interleaved in one loop, so a slow spell of the host or
    the card lands on both and shifts no estimate by itself."""
    device = resolve_device(device)
    f1, f2 = make_chained(n1), make_chained(n2)
    _warm([(f1, args), (f2, args)], device)
    t1s, t2s = [], []
    for _ in range(reps):
        t1s.append(_chain_seconds(f1, args, device, wall))
        t2s.append(_chain_seconds(f2, args, device, wall))
    t1 = float(np.median(t1s))
    return np.maximum((np.asarray(t2s) - t1) / (n2 - n1), 1e-9)


def marginal_time(make_chained, args, n1: int = 3, n2: int = 13,
                  reps: int = 7, *, device=None) -> float:
    return float(np.median(marginal_times(make_chained, args, n1, n2, reps,
                                          device=device)))


def interleaved_marginal(specs, n1: int = 4, n2: int = 20,
                         reps: int = 9, *, device=None) -> list[np.ndarray]:
    """Marginal per-op estimates for several ops with reps interleaved.

    ``specs`` is a list of ``(make_chained, args)``. The card's speed
    drifts (clocks under a power limit, other work), so a ratio of two
    separately timed measurements, such as a kernel's time over the
    bandwidth probe's that defines its roofline, inherits the drift.
    Running the short and long chains of every spec inside one rep loop
    makes the drift common to all: ratios of the returned medians, or of
    the per-rep estimates, are A/B comparisons."""
    device = resolve_device(device)
    fns = [(mk(n1), mk(n2)) for mk, _ in specs]
    _warm([(f, a) for (f1, f2), (_, a) in zip(fns, specs)
           for f in (f1, f2)], device)
    t1s: list[list[float]] = [[] for _ in specs]
    t2s: list[list[float]] = [[] for _ in specs]
    for _ in range(reps):
        for j, ((f1, f2), (_, a)) in enumerate(zip(fns, specs)):
            t1s[j].append(_chain_seconds(f1, a, device, False))
            t2s[j].append(_chain_seconds(f2, a, device, False))
    # each spec's short-chain median anchors its long reps, as in
    # marginal_times
    return [np.maximum((np.asarray(t2) - float(np.median(t1))) / (n2 - n1),
                       1e-9)
            for t1, t2 in zip(t1s, t2s)]


def _est_meta(ests) -> dict:
    """Rep count and spread of a headline latency estimate: ``spread_ms`` is
    [p10, p90] of the per-rep marginal estimates, which tells the card's
    drift from a regression."""
    e = np.asarray(ests)
    return {"reps": int(e.size),
            "spread_ms": [round(float(np.percentile(e, 10)) * 1e3, 4),
                          round(float(np.percentile(e, 90)) * 1e3, 4)]}


def make_stream_probe(m: int):
    """Chained bf16 matrix-vector products over one device-resident matrix,
    ``torch.matmul(q [1, D], X.T)``: the stream that defines the roofline
    (every byte of X read once a call; the [1, N] output is 1/D of it).
    Shared by ``measure_hbm_bw`` and the stages' interleaved probes, so the
    two cannot drift apart. It is the probe, not a port of a kernel."""
    def run(X, q):
        s = None
        for _ in range(m):
            s = torch.matmul(q, X.T)
        return s
    return run


def measure_hbm_bw(nbytes: int = 1 << 30, *, device=None) -> float:
    """Sustained streaming bandwidth (bytes/s) of ``make_stream_probe``
    over an ``nbytes`` bf16 matrix, with ``bench_query``'s chain lengths; the
    best rep, so that a kernel's fraction of it is a conservative one."""
    device = resolve_device(device)
    n = nbytes // 2
    X = torch.randn((n // 512, 512), generator=_gen(device, 0),
                    device=device, dtype=torch.bfloat16)
    q = torch.ones((1, 512), dtype=torch.bfloat16, device=device)
    ests = marginal_times(make_stream_probe, (X, q), n1=4, n2=20, reps=9,
                          device=device)
    return X.numel() * X.element_size() / float(np.min(ests))


def _gen(device: torch.device, seed: int) -> torch.Generator:
    """The generator standing for the reference's ``PRNGKey(seed)``."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.norm(x, dim=1, keepdim=True)


def _random_int8(shape, seed: int, device: torch.device) -> torch.Tensor:
    """Uniform random bytes as int8 (the reference's ``jax.random.bits``
    bitcast), drawn as uint8 so nothing wider is ever held."""
    return torch.randint(0, 256, shape, generator=_gen(device, seed),
                         dtype=torch.uint8, device=device).view(torch.int8)


def _free_bytes(device: torch.device) -> int:
    """Bytes free where ``device``'s tensors live: the card's free memory
    (``torch.cuda.mem_get_info``), or the host's available pages."""
    if device.type == "cuda":
        return int(torch.cuda.mem_get_info(device)[0])
    return os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")


def _chain(op):
    """``make_chained`` of an op: ``m`` calls of ``op(*args)`` in a row."""
    def make_chained(m):
        def run(*a):
            out = None
            for _ in range(m):
                out = op(*a)
            return out
        return run
    return make_chained


def _paired(probe_ests, ests, probe_bytes: int, ref_bytes: int) -> dict:
    """The roofline keys from paired per-rep estimates (probe rep i and
    kernel rep i ran adjacent in time); reps clamped at 1e-9 are not
    measurements and are dropped. ``ref_bytes`` is what the stage must
    stream, the probe's rate applied to it."""
    valid = (probe_ests > 2e-9) & (ests > 2e-9)
    if not valid.any():
        return {}
    pv, kv = probe_ests[valid], ests[valid]
    probe_bw = probe_bytes / float(np.median(pv))
    return {"hbm_bw_gbps": probe_bw / 1e9,
            "frac_of_roofline": float(np.median(
                (pv * (ref_bytes / probe_bytes)) / kv))}


def _latency(out: dict, ests, q_batch: int) -> dict:
    p50 = float(np.median(ests))
    out["p50_ms"] = p50 * 1e3
    out["p99_ms"] = float(np.percentile(ests, 99)) * 1e3
    out["qps"] = q_batch / p50
    out.update(_est_meta(ests))
    return out


def bench_extraction(batch: int = 128, image_size: int = 224,
                     backbone: str = "resnet50", pooling: str = "gem",
                     scales: tuple = (1.0,),
                     vit_attention: str = "auto", *, device=None) -> dict:
    """Device-side extraction throughput over a batch already on the card
    (seeded weights, ``build_extract_fn``'s function, bf16)."""
    device = resolve_device(device)
    cfg = ExtractConfig(backbone=backbone, pooling=pooling,
                        image_size=image_size, batch_size=batch,
                        scales=scales, dtype="bfloat16",
                        vit_attention=vit_attention)
    model, extract = build_extract_fn(cfg, device=device)
    model.init_weights(_gen(device, 0))
    x = torch.from_numpy(np.random.default_rng(0).random(
        (batch, image_size, image_size, 3), dtype=np.float32)).to(device)

    per_call = marginal_time(_chain(extract), (x,), n1=4, n2=16,
                             device=device)
    out = {
        "images_per_sec": batch / per_call,
        "ms_per_batch": per_call * 1e3,
        "batch": batch, "image_size": image_size, "backbone": backbone,
        "pooling": pooling, "scales": list(scales),
    }
    if backbone.startswith("vit"):
        out["attention"] = vit_attention
    return out


def bench_extraction_e2e(n_images: int = 512, image_size: int = 224,
                         backbone: str = "resnet50", pooling: str = "gem",
                         batch: int = 128, src_size: int = 256,
                         workdir: str | None = None, *, device=None) -> dict:
    """Disk -> descriptor throughput: JPEG decode on the host (the
    ``Extractor``'s prefetch thread) overlapped with extraction on the
    card, against the host stages measured alone. Each of the 3 reps
    measures decode, host-to-device transfer and the end-to-end loop back
    to back, so the three share one window of the host's load; the rep
    reported is the best end-to-end one. Host clock throughout."""
    import shutil
    import tempfile

    from .data import frontend
    from .extractor import Extractor

    device = resolve_device(device)
    d = workdir or tempfile.mkdtemp(prefix="instsearch_e2e_")
    try:
        import cv2
        rng = np.random.default_rng(0)
        paths = []
        for i in range(n_images):
            p = os.path.join(d, f"img_{i:05d}.jpg")
            if not os.path.exists(p):
                # low-frequency content: a photograph's JPEG entropy
                # (random noise is the decoder's worst case)
                low = rng.random((src_size // 8, src_size // 8, 3),
                                 np.float32)
                img = cv2.resize(low, (src_size, src_size),
                                 interpolation=cv2.INTER_CUBIC)
                cv2.imwrite(p, np.clip(img * 255, 0, 255).astype(np.uint8))
            paths.append(p)

        cfg = ExtractConfig(backbone=backbone, pooling=pooling,
                            image_size=image_size, batch_size=batch,
                            dtype="bfloat16")
        ex = Extractor(cfg, seed=0, device=device)
        ex.extract_paths(paths[:batch])          # warm outside the clock

        shape = (batch, image_size, image_size, 3)
        mk = lambda v: np.full(shape, v % 251, np.uint8)  # noqa: E731
        _put(mk(255), device)                               # warm path
        _sync(device)
        n_xfer = max(4, n_images // batch)

        reps = []
        for rep in range(3):
            # decode in situ, beside whatever else the host runs
            t0 = time.perf_counter()
            ndec = 0
            for b, idxs in frontend.batch_paths(paths, image_size, batch):
                ndec += int((idxs >= 0).sum())
            decode_rate = ndec / (time.perf_counter() - t0)

            # sustained host-to-device: a producer's loop of uploads, one
            # fence
            bufs = [mk(rep * n_xfer + v) for v in range(n_xfer)]
            t0 = time.perf_counter()
            xs = [_put(bb, device) for bb in bufs]
            _sync(device)
            t_h2d = time.perf_counter() - t0
            h2d_rate = n_xfer * batch / t_h2d
            del xs, bufs

            t0 = time.perf_counter()
            descs, kept = ex.extract_paths(paths)
            wall = time.perf_counter() - t0
            assert len(kept) == n_images
            reps.append((n_images / wall, wall, decode_rate, h2d_rate))

        e2e, wall, decode_rate, h2d_rate = max(reps)
        h2d_mbps = h2d_rate * image_size * image_size * 3 / 1e6
        # decode and upload share the host: their serial composition is the
        # bound where they share one core, min(decode, transfer) where not
        serial_bound = 1.0 / (1.0 / decode_rate + 1.0 / h2d_rate)
        return {
            "images_per_sec_e2e": e2e,
            "wall_sec": wall, "n_images": n_images,
            "image_size": image_size, "src_size": src_size,
            "backbone": backbone, "reps": len(reps),
            "e2e_spread_img_s": [round(r[0], 1) for r in reps],
            "decode_images_per_sec_insitu": decode_rate,
            "host_to_device_mbps_sustained": h2d_mbps,
            "transfer_bound_images_per_sec": h2d_rate,
            "serial_host_bound_images_per_sec": serial_bound,
            "frac_of_transfer_bound": e2e / h2d_rate,
            "pipeline_efficiency": e2e / serial_bound,
        }
    finally:
        if workdir is None:
            shutil.rmtree(d, ignore_errors=True)


def _put(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """An upload as the input pipeline makes it (``data/loader.py``): a
    pinned host copy sent without blocking."""
    t = torch.from_numpy(a)
    return t.pin_memory().to(device, non_blocking=True) \
        if device.type == "cuda" else t.to(device)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def bench_query(n: int = 1_048_576, d: int = 512, k: int = 10,
                q_batch: int = 1, use_pallas: bool = True,
                dtype: str = "bfloat16",
                hbm_bw: float | None = None,
                roofline: bool = True, *, device=None) -> dict:
    """Brute-force top-k over a device-resident ``[N, D]`` store: K1 over
    bf16 rows (``kernels/topk_matmul.py::topk_matmul``), K2 over int8
    (``topk_matmul_int8``), K3 over packed int4 (``topk_matmul_int4``), or
    with ``use_pallas=False`` the scoring oracle (``search_topk``).

    ``roofline=True`` (card only) times the bf16 stream over the same bf16
    matrix interleaved rep for rep with the kernel and derives
    ``frac_of_roofline`` from the paired reps; ``hbm_bw`` (bytes/s) is the
    reference rate when the interleaved probe is off."""
    device = resolve_device(device)
    on_card = device.type == "cuda"
    from .kernels.topk_matmul import (topk_matmul, topk_matmul_int4,
                                      topk_matmul_int8)
    from .ops.quantize import quantize_rows, quantize_rows_int4

    # capacity-scale int4: the f32 generation and quantization hold about
    # four f32 copies of the store at their peak; where that exceeds what
    # is free (mem_get_info: the 8M x 512 query of run_bench's 'extended'
    # on an 80 GB card, 64 GiB against ~79 free), stream random packed
    # bytes instead and skip the probe, which would need the bf16 matrix
    int4_capacity = (dtype == "int4"
                     and 4 * n * d * 4 > 0.8 * _free_bytes(device))
    if int4_capacity:
        bits = torch.randint(0, 256, (q_batch, d), generator=_gen(device, 0),
                             device=device, dtype=torch.uint8)
        Xd, q = None, ((bits.float() - 127.0) / 128.0).to(torch.bfloat16)
        roofline = False
    else:
        X = _unit(torch.randn((n, d), generator=_gen(device, 0),
                              device=device))
        Xd, q = X.to(torch.bfloat16), X[:q_batch].to(torch.bfloat16)
        del X
    item_bytes = 2

    if dtype == "int8":
        qr = quantize_rows(Xd.float())
        op = lambda V, S, qq: topk_matmul_int8(V, S, qq, k=k)  # noqa: E731
        args = (qr.values, qr.scales, q.float())
        path = "kernel-int8" if on_card else "plain"
        item_bytes = 1
    elif dtype == "int4":
        if int4_capacity:
            values = _random_int8((n, d // 2), 1, device)
            scales = torch.full((1, n), 1.0 / 112.0, device=device)
        else:
            qr = quantize_rows_int4(Xd.float())
            values, scales = qr.values, qr.scales
        op = lambda V, S, qq: topk_matmul_int4(V, S, qq, k=k)  # noqa: E731
        args = (values, scales, q.float())
        path = "kernel-int4" if on_card else "plain"
        item_bytes = 0.5           # two components per streamed byte
    elif use_pallas and on_card:
        op = lambda X, qq: topk_matmul(X, qq, k=k)  # noqa: E731
        args = (Xd, q)
        path = "kernel"
    else:
        from .search.bruteforce import search_topk
        op = lambda X, qq: search_topk(X, qq, k=k)  # noqa: E731
        args = (Xd, q)
        path = "torch" if on_card else "plain"

    # bytes the scan streams: the store (int8/int4 also their [1, N] f32
    # row scales); the queries and outputs are negligible beside it
    scan_bytes = int(n * d * item_bytes) + (
        n * 4 if dtype in ("int8", "int4") else 0)
    out = {"n": n, "d": d, "k": k, "q_batch": q_batch, "path": path}

    if roofline and on_card:
        # the probe over the SAME matrix, interleaved rep for rep with the
        # kernel. On an H100 the int8 and int4 kernels stream fewer bytes
        # than the bf16 probe at a lower rate than the probe's, so their
        # fraction stays below 1 (PERF.md records the readings)
        q1 = torch.ones((1, d), dtype=torch.bfloat16, device=device)
        probe_ests, ests = interleaved_marginal(
            [(make_stream_probe, (Xd, q1)), (_chain(op), args)],
            device=device)
        valid = (probe_ests > 2e-9) & (ests > 2e-9)
        if valid.any():
            probe_bytes = n * d * 2
            pv, kv = probe_ests[valid], ests[valid]
            probe_bw = probe_bytes / float(np.median(pv))
            out["hbm_bw_gbps"] = probe_bw / 1e9
            out["hbm_roofline_ms"] = scan_bytes / probe_bw * 1e3
            out["frac_of_roofline"] = float(np.median(
                (pv * (scan_bytes / probe_bytes)) / kv))
    else:
        # long chains: short ones leave the fixed cost's jitter a large
        # share of the difference
        ests = marginal_times(_chain(op), args, n1=4, n2=20, reps=9,
                              device=device)
        if hbm_bw:
            roofline_ms = scan_bytes / hbm_bw * 1e3
            out["hbm_bw_gbps"] = hbm_bw / 1e9
            out["hbm_roofline_ms"] = roofline_ms
            out["frac_of_roofline"] = roofline_ms / (
                float(np.median(ests)) * 1e3)

    p50 = float(np.median(ests))
    out["effective_gbps"] = scan_bytes / p50 / 1e9
    out["p50_ms"] = p50 * 1e3
    out["p99_ms"] = float(np.percentile(ests, 99)) * 1e3
    out["qps"] = q_batch / p50
    out.update(_est_meta(ests))
    return out


def bench_filtered_query(n: int = 1_048_576, d: int = 512, k: int = 10,
                         frac: float = 0.5, *, device=None) -> dict:
    """K1 with its ``[1, N]`` subset mask (``search/subset.py``) against the
    unfiltered K1 over the same store, interleaved rep for rep. The mask
    adds one byte a row to the stream (1/1024 of a bf16 row at D = 512)
    and a compare a tile, so the expectation is an overhead ratio near 1.
    Also checks membership on the card: every returned row is allowed."""
    from .kernels.topk_matmul import topk_matmul

    device = resolve_device(device)
    Xd, q = _make_index_device(n, d, 1, device=device)
    qb = q.to(torch.bfloat16)
    mask = (torch.rand((1, n), generator=_gen(device, 7), device=device)
            < frac).to(torch.int8)

    m_ests, p_ests = interleaved_marginal([
        (_chain(lambda X, M, qq: topk_matmul(X, qq, k=k, mask=M)),
         (Xd, mask, qb)),
        (_chain(lambda X, qq: topk_matmul(X, qq, k=k)), (Xd, qb))],
        device=device)
    valid = (m_ests > 2e-9) & (p_ests > 2e-9)
    p50 = float(np.median(m_ests))
    out = {"n": n, "d": d, "k": k, "subset_frac": frac,
           "p50_ms": p50 * 1e3,
           "unfiltered_p50_ms": float(np.median(p_ests)) * 1e3}
    if valid.any():
        # the paired per-rep ratio: the drift-immune overhead
        out["overhead_ratio"] = float(np.median(
            m_ests[valid] / p_ests[valid]))
    out.update(_est_meta(m_ests))
    # membership: one real call
    _, ids = topk_matmul(Xd, qb, k=k, mask=mask)
    allowed = mask[0][ids.clamp(min=0).long()]
    out["members_only"] = bool((allowed > 0).all())
    return out


def _make_index_device(n: int, d: int, q_batch: int, seed: int = 0,
                       device=None):
    """Unit-norm ``[n, d]`` bf16 store and its first ``q_batch`` rows as f32
    queries, drawn on the device (content does not matter to a scan)."""
    device = resolve_device(device)
    X = _unit(torch.randn((n, d), generator=_gen(device, seed),
                          device=device))
    return X.to(torch.bfloat16), X[:q_batch].clone()


def _make_clustered_device(n: int, d: int, q_batch: int,
                           n_centers: int = 4096, noise: float = 0.5,
                           seed: int = 0, device=None):
    """Mixture-of-gaussians store and out-of-sample queries, on the device.

    ANN recall on i.i.d. gaussian rows measures a data pathology: with no
    cluster structure a coarse quantizer has nothing to find. Here: unit
    centers, per-row noise of norm about ``noise`` (within-cluster cosine
    about 1/(1 + noise^2)), more generator centers than the ANN tiers'
    clusters (their partitions never align by construction), and queries
    drawn fresh from the mixture, never perturbed store rows. Each query
    mixes TWO centers (weights in [0.35, 0.65]): a query between two modes
    has a top-k that straddles cells, the regime ``nprobe`` exists for. One
    generator seeded ``seed`` draws, in order, the centers, assignments,
    row noise, the queries' two centers, their weights and noise."""
    device = resolve_device(device)
    g = _gen(device, seed)
    centers = _unit(torch.randn((n_centers, d), generator=g, device=device))
    sigma = noise / math.sqrt(d)
    assign = torch.randint(0, n_centers, (n,), generator=g, device=device)
    X = centers[assign]
    X += sigma * torch.randn((n, d), generator=g, device=device)
    X = _unit(X)
    ca = torch.randint(0, n_centers, (q_batch,), generator=g, device=device)
    cb = torch.randint(0, n_centers, (q_batch,), generator=g, device=device)
    lam = 0.35 + 0.3 * torch.rand((q_batch, 1), generator=g, device=device)
    q = (lam * centers[ca] + (1.0 - lam) * centers[cb]
         + sigma * torch.randn((q_batch, d), generator=g, device=device))
    return X.to(torch.bfloat16), _unit(q)


def bench_qe(n: int = 1_048_576, d: int = 512, k: int = 10, qe_n: int = 10,
             q_batch: int = 1, dtype: str = "bfloat16", *,
             device=None) -> dict:
    """Alpha query expansion end to end: the index's composite
    (``index.py::_search_composite`` with αQE: the top-``qe_n`` through the
    fused kernel, the rows gathered, the expanded query, the final top-k).
    Two full scans, so the reference stream is twice the bf16 probe's
    bytes over the same rows."""
    from .index import _search_composite
    from .ops.quantize import quantize_rows

    device = resolve_device(device)
    on_card = device.type == "cuda"
    Xb, q = _make_index_device(n, d, q_batch, device=device)
    ids = torch.arange(n, dtype=torch.int32, device=device)
    Xd, scales = Xb, None
    if dtype == "int8":
        qr = quantize_rows(Xb.float())
        Xd, scales = qr.values, qr.scales
    item_bytes = 1 if dtype == "int8" else 2

    def op(X, ids, qq, scales):
        return _search_composite(
            X, ids, qq, n, scales, k=k, qe_n=qe_n, qe_alpha=3.0,
            use_kernel=on_card, do_qe=True)

    args = (Xd, ids, q, scales)
    scan_bytes = 2 * (n * d * item_bytes + (n * 4 if dtype == "int8" else 0))
    out = {"n": n, "d": d, "k": k, "qe_n": qe_n, "q_batch": q_batch,
           "dtype": dtype, "scans": 2}
    if on_card:
        q1 = torch.ones((1, d), dtype=torch.bfloat16, device=device)
        probe_ests, ests = interleaved_marginal(
            [(make_stream_probe, (Xb, q1)), (_chain(op), args)],
            n1=3, n2=11, device=device)
        out.update(_paired(probe_ests, ests, n * d * 2, scan_bytes))
    else:
        ests = marginal_times(_chain(op), args, n1=3, n2=11, reps=7,
                              device=device)
    return _latency(out, ests, q_batch)


def bench_diffusion(n: int = 1_048_576, d: int = 512, k: int = 10,
                    depth: int = 200, q_batch: int = 1,
                    knn: int = 10, iters: int = 20, *, device=None) -> dict:
    """Diffusion re-ranking end to end: the composite's top-``depth``
    through the fused kernel, the ``[Q, depth, D]`` rows gathered, the
    mutual-kNN graph, ``iters`` CG steps, the re-rank. One full scan leads
    at B=1 (the ``[depth, depth]`` solve is far smaller), so the reference
    is the bf16 probe over the same rows."""
    from .index import _search_composite

    device = resolve_device(device)
    on_card = device.type == "cuda"
    Xd, q = _make_index_device(n, d, q_batch, device=device)
    ids = torch.arange(n, dtype=torch.int32, device=device)

    def op(X, ids, qq):
        return _search_composite(
            X, ids, qq, n, None, k=k, depth=depth, qe_n=0, qe_alpha=3.0,
            use_kernel=on_card, do_qe=False, do_diffusion=True,
            diff_knn=knn, diff_iters=iters)

    args = (Xd, ids, q)
    scan_bytes = n * d * 2
    out = {"n": n, "d": d, "k": k, "depth": depth, "knn": knn,
           "iters": iters, "q_batch": q_batch}
    if on_card:
        q1 = torch.ones((1, d), dtype=torch.bfloat16, device=device)
        probe_ests, ests = interleaved_marginal(
            [(make_stream_probe, (Xd, q1)), (_chain(op), args)],
            n1=4, n2=20, device=device)
        out.update(_paired(probe_ests, ests, scan_bytes, scan_bytes))
    else:
        ests = marginal_times(_chain(op), args, n1=4, n2=20, reps=7,
                              device=device)
    return _latency(out, ests, q_batch)


def bench_dba(n: int = 1_048_576, d: int = 512, dba_n: int = 10,
              chunk: int = 128, *, device=None) -> dict:
    """αDBA's offline augmentation rate: rows/s through the chunked
    self-search of ``Index.augment_database`` (one fused top-``dba_n`` of a
    ``chunk`` of stored rows against the whole store, the neighbours
    gathered and weighted, ``index.py::_expand(include_query=False)``).
    The whole pass is n/chunk such scans; it is timed over a few chunks
    (the program is the same for every chunk), each fenced, on the host's
    clock, and extrapolated to all rows."""
    from .index import _expand

    device = resolve_device(device)
    on_card = device.type == "cuda"
    Xd, _ = _make_index_device(n, d, 1, device=device)
    ids = torch.arange(n, dtype=torch.int32, device=device)

    def one_chunk(start):
        return _expand(Xd, ids, Xd[start:start + chunk].float(), n, None,
                       qe_n=dba_n, qe_alpha=3.0, use_kernel=on_card,
                       int4=False, include_query=False)

    one_chunk(0)
    _sync(device)
    sample = 4
    t0 = time.perf_counter()
    for i in range(sample):
        one_chunk(i * chunk)
        _sync(device)
    per_chunk = (time.perf_counter() - t0) / sample
    total_s = per_chunk * (n / chunk)
    return {"n": n, "d": d, "dba_n": dba_n, "chunk": chunk,
            "per_chunk_ms": per_chunk * 1e3,
            "rows_per_sec": chunk / per_chunk,
            "est_total_sec_1M": total_s}


def bench_refine(n: int = 1_048_576, d: int = 512, depth: int = 100,
                 k: int = 10, q_batch: int = 1, *, device=None) -> dict:
    """The exact-refine tier end to end: K3's int4 scan for the top
    ``depth``, then their int8 copies re-scored (the composite with
    ``do_refine``). The reference stream: the bf16 probe's rate over the
    int4 scan's bytes and the ``[Q, depth, D]`` int8 gather."""
    from .index import _search_composite
    from .ops.quantize import quantize_rows, quantize_rows_int4

    device = resolve_device(device)
    on_card = device.type == "cuda"
    Xd, q = _make_index_device(n, d, q_batch, device=device)
    ids = torch.arange(n, dtype=torch.int32, device=device)
    qr4 = quantize_rows_int4(Xd.float())
    qr8 = quantize_rows(Xd.float())
    refine_vals = qr8.values[:, None, :]                    # [N, 1, D]
    refine_scales = qr8.scales.reshape(n, 1)

    def op(V, S, ids, qq, rv, rs):
        return _search_composite(
            V, ids, qq, n, S, rv, rs, k=k, depth=depth, qe_n=0,
            qe_alpha=3.0, use_kernel=on_card, do_qe=False, int4=True,
            do_refine=True)

    args = (qr4.values, qr4.scales, ids, q, refine_vals, refine_scales)
    scan_bytes = n * d // 2 + n * 4
    gather_bytes = q_batch * depth * d
    out = {"n": n, "d": d, "depth": depth, "k": k, "q_batch": q_batch,
           "bytes_per_component": 1.5}
    if on_card:
        q1 = torch.ones((1, d), dtype=torch.bfloat16, device=device)
        probe_ests, ests = interleaved_marginal(
            [(make_stream_probe, (Xd, q1)), (_chain(op), args)],
            n1=3, n2=11, device=device)
        out.update(_paired(probe_ests, ests, n * d * 2,
                           scan_bytes + gather_bytes))
    else:
        ests = marginal_times(_chain(op), args, n1=3, n2=11, reps=7,
                              device=device)
    return _latency(out, ests, q_batch)


def bench_pq(n: int = 1_048_576, d: int = 512, k: int = 10,
             depth: int = 100, q_batch: int = 1, m: int | None = None,
             iters: int = 8, fit_rows: int = 131_072, *, device=None) -> dict:
    """The PQ cascade end to end (``search/pq_view.py::_pq_composite``): K4's
    ADC scan over the 4-bit codes (M/2 bytes a row) for ``depth``
    candidates, then their exact re-score against the bf16 store. The
    codebook is fitted on the first ``fit_rows`` rows and every row encoded
    on the device. The reference stream: the bf16 probe's rate over the
    code stream and the candidates' rows; ``speedup_vs_full_stream`` is
    against one bf16 scan. Quality: recall@k against the exact scan (K1)
    as a curve over the depth (the cascade re-scores exactly, so recall@k
    is the recall of the depth-candidate set), and the same with an OPQ
    rotation (``ops/pq.py::fit_opq``) at ``depth``."""
    from functools import partial

    from .kernels.pq_scan import pq_topk
    from .kernels.topk_matmul import topk_matmul
    from .ops.pq import decode_pq, encode_pq, fit_opq, fit_pq
    from .search.bruteforce import gather_rows_f32, search_topk
    from .search.ivf import recall_vs_exact
    from .search.pq_view import PQView, _pq_composite

    device = resolve_device(device)
    on_card = device.type == "cuda"
    if m is None:
        m = max(2, d // 8)
    # mixture-structured rows and out-of-sample queries (see
    # _make_clustered_device)
    Xd, qs_all = _make_clustered_device(n, d, max(q_batch, 32),
                                        device=device)
    q = qs_all[:q_batch]
    ids = torch.arange(n, dtype=torch.int32, device=device)

    t0 = time.perf_counter()
    fit_x = Xd[:min(fit_rows, n)].float()
    cb = fit_pq(fit_x, m=m, iters=iters)
    # encode in slices: an f32 copy of the whole store never exists
    enc_chunk = 262_144 if n % 262_144 == 0 else n
    codes = torch.cat([encode_pq(Xd[s:s + enc_chunk].float(), cb)
                       for s in range(0, n, enc_chunk)])
    view = PQView(cb, codes, depth=depth)   # codes padded for K4's words
    _sync(device)
    build_s = time.perf_counter() - t0
    rows_f32 = partial(gather_rows_f32, Xd)

    def op(packed, qq):
        return _pq_composite(packed, cb.centroids, rows_f32, ids, qq, n,
                             k=k, depth=depth, qe_n=0, qe_alpha=3.0,
                             do_qe=False, use_kernel=on_card)

    args = (view.packed, q)
    scan_bytes = n * (m // 2)                       # the code stream
    gather_bytes = q_batch * depth * d * 2          # exact re-score rows
    out = {"n": n, "d": d, "k": k, "depth": depth, "q_batch": q_batch,
           "m": m, "bytes_per_row": m // 2,
           "build_sec": round(build_s, 2)}
    if on_card:
        q1 = torch.ones((1, d), dtype=torch.bfloat16, device=device)
        probe_ests, ests = interleaved_marginal(
            [(make_stream_probe, (Xd, q1)), (_chain(op), args)],
            n1=3, n2=11, device=device)
        valid = (probe_ests > 2e-9) & (ests > 2e-9)
        if valid.any():
            pv, kv = probe_ests[valid], ests[valid]
            probe_bytes = n * d * 2
            ref_bytes = scan_bytes + gather_bytes
            out["hbm_bw_gbps"] = probe_bytes / float(np.median(pv)) / 1e9
            out["frac_of_pq_roofline"] = float(
                np.median((pv * (ref_bytes / probe_bytes)) / kv))
            out["speedup_vs_full_stream"] = float(np.median(pv / kv))
    else:
        ests = marginal_times(_chain(op), args, n1=3, n2=11, reps=7,
                              device=device)
    p50 = float(np.median(ests))
    out["p50_ms"] = p50 * 1e3
    out["p99_ms"] = float(np.percentile(ests, 99)) * 1e3
    out["qps"] = q_batch / p50
    qs = qs_all[:32]
    if on_card:
        _, exact_ids = topk_matmul(Xd, qs.to(torch.bfloat16), k=k)
        cand_at = lambda dd: pq_topk(view.packed, qs, cb, k=dd)[1]  # noqa
    else:
        _, exact_ids = search_topk(Xd, qs.to(torch.bfloat16), k=k)
        dec_scores = qs @ decode_pq(codes, cb).T
        cand_at = lambda dd: torch.argsort(  # noqa: E731
            -dec_scores, dim=1, stable=True)[:, :dd]
    exact_ids = exact_ids.cpu().numpy()
    curve = {}
    for dd in sorted({depth, 1024}):
        curve[str(dd)] = round(recall_vs_exact(
            exact_ids, cand_at(dd).cpu().numpy()), 4)
    out["recall_at_k_vs_depth"] = curve
    out["recall_at_k"] = curve[str(depth)]

    # OPQ at the same depth: a learned rotation at the same bytes a row;
    # the scan is the same kernel, the query rotates once
    rot, cb_o = fit_opq(fit_x, m=m, opq_iters=4, pq_iters=iters,
                        refine_iters=3)
    codes_o = torch.cat([encode_pq(Xd[s:s + enc_chunk].float() @ rot, cb_o)
                         for s in range(0, n, enc_chunk)])
    qs_rot = qs @ rot
    if on_card:
        cand_o = pq_topk(PQView(cb_o, codes_o).packed, qs_rot, cb_o,
                         k=depth)[1]
    else:
        cand_o = torch.argsort(-(qs_rot @ decode_pq(codes_o, cb_o).T),
                               dim=1, stable=True)[:, :depth]
    out["recall_at_k_opq"] = round(recall_vs_exact(
        exact_ids, cand_o.cpu().numpy()), 4)
    return out


def bench_pq_capacity(n: int = 67_108_864, d: int = 512, m: int = 64,
                      depth: int = 100,
                      q_batches: tuple = (1, 128), *, device=None) -> dict:
    """The PQ tier where only its codes fit one card: 64M rows at D = 512
    are 64 GiB in bf16, 32 GiB int8 and ~16 GiB packed int4, but 2 GiB of
    4-bit codes (M = 64). This times the codes-only ADC scan (K4 at top
    ``depth``); the exact re-score would read the candidates' rows from
    host storage (``bench_host_serve``). The codes are random bytes drawn
    on the device: the scan's time does not depend on their content (every
    byte is a valid nibble pair), and recall is ``bench_pq``'s. One entry a
    query batch in ``q_batches``; no interleaved probe (``effective_gbps``
    is the code stream's rate)."""
    from .kernels.pq_scan import pq_topk
    from .ops.pq import PQCodebook, decode_pq
    from .search.bruteforce import select_topk

    device = resolve_device(device)
    on_card = device.type == "cuda"
    groups = m // 2
    max_b = max(q_batches)
    codes = _random_int8((n, groups), 3, device)
    cb = PQCodebook(torch.randn((m, 16, d // m), generator=_gen(device, 4),
                                device=device))
    qall = _unit(torch.randn((max_b, d), generator=_gen(device, 5),
                             device=device))

    def op(codes, qq):
        if on_card:
            return pq_topk(codes, qq, cb, k=depth, num_valid=n)
        # the CPU's route at toy n: the scoring oracle, the same shapes
        return select_topk(qq @ decode_pq(codes, cb).T, depth)

    scan_bytes = n * groups
    out = {"n": n, "d": d, "m": m, "depth": depth,
           "codes_gb": round(scan_bytes / 2**30, 2),
           "bf16_equiv_gb": round(n * d * 2 / 2**30, 1),
           "int4_equiv_gb": round(n * (d // 2 + 4) / 2**30, 1),
           "per_batch": {}}
    for b in q_batches:
        ests = marginal_times(_chain(op), (codes, qall[:b]), n1=2, n2=6,
                              reps=5, device=device)
        p50 = float(np.median(ests))
        out["per_batch"][str(b)] = {
            "p50_ms": p50 * 1e3,
            "p99_ms": float(np.percentile(ests, 99)) * 1e3,
            "qps": b / p50,
            "effective_gbps": scan_bytes / p50 / 1e9}
    b0 = str(q_batches[0])
    out["q_batch"] = q_batches[0]
    for key in ("p50_ms", "p99_ms", "qps", "effective_gbps"):
        out[key] = out["per_batch"][b0][key]
    return out


def _ann_index(n: int, d: int, k: int, q_batch: int, device):
    """The ANN stages' bf16 index over the mixture store (row tile 4096,
    the kernel route on), with 32 out-of-sample queries for the recall
    curves: ``(index, all queries, timed queries)``."""
    from .config import IndexConfig, PipelineConfig, SearchConfig
    from .index import Index

    Xd, qs_all = _make_clustered_device(n, d, max(q_batch, 32),
                                        device=device)
    cfg = PipelineConfig(index=IndexConfig(dtype="bfloat16", row_tile=4096),
                         search=SearchConfig(k=k, use_pallas=True))
    idx = Index(Xd, torch.arange(n, dtype=torch.int32, device=device),
                [""] * n, cfg)
    return idx, qs_all, qs_all[:q_batch]


def _exact_ids(idx, qs_all, k: int) -> np.ndarray:
    """The exact ranking with every candidate tier's routing off (with a
    view armed, the "exact" side would be the ANN answer itself)."""
    _, exact_ids = idx.search(qs_all, idx.cfg.search.replace(
        k=k, qe_enabled=False, rerank_enabled=False, ivf_nprobe=0,
        pq_depth=0, ivfpq_nprobe=0))
    return exact_ids


def bench_ivf(n: int = 1_048_576, d: int = 512, k: int = 10,
              q_batch: int = 1, n_clusters: int = 1024,
              nprobe: int = 32, cap_factor: float = 2.0,
              recall_nprobes: tuple = (1, 8, 32, 128), *, device=None) -> dict:
    """The IVF tier (``Index.build_ivf``: the k-means fit and the buckets on
    the device) and its pruned scan (``search/ivf.py::_ivf_composite``),
    with recall@k against the exact scan (K1) for each nprobe in
    ``recall_nprobes``, on out-of-sample mixture queries. A query reads
    about nprobe/n_clusters of the rows plus the spill, so the reference
    stream is the bf16 probe scaled to that fraction."""
    from .search.ivf import _ivf_composite, recall_vs_exact

    device = resolve_device(device)
    on_card = device.type == "cuda"
    idx, qs_all, q = _ann_index(n, d, k, q_batch, device)
    t0 = time.perf_counter()
    ivf = idx.build_ivf(n_clusters=n_clusters, nprobe=nprobe,
                        cap_factor=cap_factor)
    _sync(device)
    build_s = time.perf_counter() - t0

    def op(qq):
        return _ivf_composite(ivf.arrays, idx._rows_f32_at, idx.ids, None,
                              None, qq, k=k, depth=0, qe_n=0, qe_alpha=3.0,
                              nprobe=nprobe, do_qe=False, do_rerank=False)

    scan_frac = ivf.scan_fraction()
    out = {"n": n, "d": d, "k": k, "q_batch": q_batch,
           "n_clusters": ivf.n_clusters, "nprobe": nprobe,
           "cap_factor": cap_factor, "scan_fraction": round(scan_frac, 4),
           "build_sec": round(build_s, 2)}
    if on_card:
        q1 = torch.ones((1, d), dtype=torch.bfloat16, device=device)
        probe_ests, ests = interleaved_marginal(
            [(make_stream_probe, (idx.descriptors, q1)), (_chain(op), (q,))],
            n1=3, n2=11, device=device)
        valid = (probe_ests > 2e-9) & (ests > 2e-9)
        if valid.any():
            pv, kv = probe_ests[valid], ests[valid]
            out["frac_of_scanned_roofline"] = float(
                np.median((pv * scan_frac) / kv))
            out["speedup_vs_full_stream"] = float(np.median(pv / kv))
    else:
        ests = marginal_times(_chain(op), (q,), n1=3, n2=11, reps=7,
                              device=device)
    _latency(out, ests, q_batch)
    exact_ids = _exact_ids(idx, qs_all, k)
    curve = {}
    for p in recall_nprobes:
        p_eff = min(p, ivf.n_clusters)
        _, ivf_ids = ivf.search(idx, qs_all, k=k, nprobe=p_eff)
        curve[str(p_eff)] = round(recall_vs_exact(exact_ids, ivf_ids), 4)
    out["recall_at_k_vs_nprobe"] = curve
    out["recall_at_k"] = curve.get(str(min(nprobe, ivf.n_clusters)))
    if out["recall_at_k"] is None:
        out["recall_at_k"] = round(ivf.measure_recall(idx, qs_all, k=k), 4)
    return out


def bench_ivfpq(n: int = 1_048_576, d: int = 512, k: int = 10,
                q_batch: int = 1, n_clusters: int = 1024,
                nprobe: int = 32, m: int = 64, depth: int = 400,
                recall_nprobes: tuple = (1, 8, 32),
                recall_depths: tuple = (100,),
                host_quality: bool = True, *, device=None) -> dict:
    """The IVF-PQ cascade (``search/ivfpq.py``): the coarse fit and the
    residual codes on the device (6 k-means and 8 PQ iterations on 131,072
    rows), then the candidates stage (pruned ADC for ``depth`` candidates,
    their exact re-score) timed at the default operating point, depth 400,
    with the recall curve over nprobe at that depth and recall-only points
    at ``recall_depths``. ``host_quality`` adds the capacity-serving
    quality triple, plainly fitted and with the score-aware fit
    (``anisotropic_t=0.2``): the device cascade, ``search_host`` against an
    int8 ``HostRowStore`` of the same rows (the store's quantization is the
    only difference) and the raw ADC ranking (``search_adc``)."""
    import shutil
    import tempfile

    from .search.ivf import recall_vs_exact
    from .search.ivfpq import HostRowStore, IVFPQView, _ivfpq_candidates

    device = resolve_device(device)
    on_card = device.type == "cuda"
    idx, qs_all, q = _ann_index(n, d, k, q_batch, device)
    t0 = time.perf_counter()
    v = IVFPQView.from_index(idx, n_clusters=n_clusters, nprobe=nprobe,
                             m=m, depth=depth, kmeans_iters=6,
                             pq_iters=8, sample=131_072)
    _sync(device)
    build_s = time.perf_counter() - t0

    def op(qq):
        return _ivfpq_candidates(v.arrays, idx._rows_f32_at, qq,
                                 depth=depth, nprobe=nprobe)

    out = {"n": n, "d": d, "k": k, "q_batch": q_batch,
           "n_clusters": v.n_clusters, "nprobe": nprobe, "m": m,
           "depth": depth, "bytes_per_row": v.bytes_per_row,
           "scan_fraction": round(v.scan_fraction(), 4),
           "build_sec": round(build_s, 2)}
    if on_card:
        # long chains: the op is short, so 128 marginal calls keep its
        # signal well above the reps' jitter
        q1 = torch.ones((1, d), dtype=torch.bfloat16, device=device)
        probe_ests, ests = interleaved_marginal(
            [(make_stream_probe, (idx.descriptors, q1)), (_chain(op), (q,))],
            n1=8, n2=136, reps=7, device=device)
        valid = (probe_ests > 2e-9) & (ests > 2e-9)
        if valid.any():
            out["speedup_vs_full_stream"] = float(np.median(
                probe_ests[valid] / ests[valid]))
    else:
        ests = marginal_times(_chain(op), (q,), n1=3, n2=11, reps=7,
                              device=device)
    _latency(out, ests, q_batch)
    # the recall curve at the TIMED depth, so that curve and latency
    # describe one program; contrast depths carry recall only
    exact_ids = _exact_ids(idx, qs_all, k)
    curve = {}
    for p in recall_nprobes:
        p_eff = min(p, v.n_clusters)
        _, got = v.search(idx, qs_all, k=k, nprobe=p_eff, depth=depth)
        curve[str(p_eff)] = round(recall_vs_exact(exact_ids, got), 4)
    out["recall_at_k_vs_nprobe"] = curve
    out["recall_at_k"] = curve.get(str(min(nprobe, v.n_clusters)))
    for cd in recall_depths:
        _, got = v.search(idx, qs_all, k=k, depth=cd, nprobe=nprobe)
        out[f"recall_at_k_depth{cd}"] = round(
            recall_vs_exact(exact_ids, got), 4)
    if host_quality:
        base = tempfile.mkdtemp(prefix="instsearch_ivfpq_q_")
        try:
            rows_f32 = idx._rows_f32_chunk(0, n)[:, :d].cpu().numpy()
            store = HostRowStore.create(os.path.join(base, "s"), rows_f32,
                                        dtype="int8")
            del rows_f32
            qs_np = qs_all.cpu().numpy()
            out["host_quality"] = {}
            for label, va in (("plain", v), ("anisotropic_t0.2", None)):
                if va is None:
                    va = IVFPQView.from_index(
                        idx, n_clusters=n_clusters, nprobe=nprobe, m=m,
                        depth=depth, kmeans_iters=6, pq_iters=8,
                        sample=131_072, anisotropic_t=0.2)
                _, got_host = va.search_host(store, qs_np, k=k)
                _, got_adc = va.search_adc(qs_np, k=k)
                _, got_dev = va.search(idx, qs_all, k=k)
                out["host_quality"][label] = {
                    "recall_at_k_cascade_device": round(
                        recall_vs_exact(exact_ids, got_dev), 4),
                    "recall_at_k_cascade_host": round(
                        recall_vs_exact(exact_ids, got_host), 4),
                    "recall_at_k_adc_only": round(
                        recall_vs_exact(exact_ids, got_adc), 4),
                }
        finally:
            shutil.rmtree(base, ignore_errors=True)
    return out


def _synthetic_ivfpq(n: int, d: int, m: int, n_clusters: int, max_b: int,
                     seed: int, device, permute: bool):
    """A capacity-scale IVF-PQ view's arrays drawn on the device (random
    codes, unit centroids, a random residual codebook, unit queries; the
    ADC's time does not depend on their content): ``(centroids, codes
    [C, cap, m/2], bucket positions [C, cap], PQ centroids, queries)``.
    Positions are ``arange`` or, with ``permute``, a random permutation,
    so candidates scatter over a host file as a real build's would."""
    groups, cap = m // 2, n // n_clusters
    g = _gen(device, seed)
    codes = torch.randint(0, 256, (n_clusters, cap, groups), generator=g,
                          dtype=torch.uint8, device=device).view(torch.int8)
    cents = _unit(torch.randn((n_clusters, d), generator=g, device=device))
    pqc = torch.randn((m, 16, d // m), generator=g, device=device)
    qall = _unit(torch.randn((max_b, d), generator=g, device=device))
    bpos = (torch.randperm(n, generator=g, device=device) if permute
            else torch.arange(n, device=device)).to(torch.int32)
    return cents, codes, bpos.reshape(n_clusters, cap), pqc, qall


def _no_spill(groups: int, device):
    return (torch.zeros((0, groups), dtype=torch.int8, device=device),
            torch.zeros((0,), dtype=torch.int32, device=device),
            torch.zeros((0,), dtype=torch.int32, device=device))


def bench_ivfpq_capacity(n: int = 67_108_864, d: int = 512, m: int = 64,
                         n_clusters: int = 8192, nprobe: int = 64,
                         depth: int = 400,
                         q_batches: tuple = (1, 128), *, device=None) -> dict:
    """IVF-PQ where only the 2 GiB of codes fit the card
    (``bench_pq_capacity``'s setting), the ADC pruned to nprobe/n_clusters
    of them: ``search/ivfpq.py::_adc_select`` at the production depth
    (400), for each query batch in ``q_batches``. Codes are random bytes in
    synthetic buckets (the ADC's time does not depend on content); there
    is no exact re-score (``bench_host_serve`` measures it from a host
    store)."""
    from .search.ivfpq import _adc_select

    device = resolve_device(device)
    groups = m // 2
    cents, codes, bpos, pqc, qall = _synthetic_ivfpq(
        n, d, m, n_clusters, max(q_batches), 7, device, permute=False)
    spill = _no_spill(groups, device)

    def op(qq):
        return _adc_select(cents, codes, bpos, *spill, pqc, None, qq,
                           depth=depth, nprobe=nprobe)

    out = {"n": n, "d": d, "m": m, "n_clusters": n_clusters,
           "nprobe": nprobe, "depth": depth,
           "codes_gb": round(n * groups / 2**30, 2),
           "scan_fraction": round(nprobe / n_clusters, 4),
           "per_batch": {}}
    for b in q_batches:
        # small batches: a short op, so longer chains; large ones: the
        # per-query bucket gather makes the op long and short chains do
        n1, n2 = (4, 36) if b < 32 else (2, 6)
        ests = marginal_times(_chain(op), (qall[:b],), n1=n1, n2=n2, reps=7,
                              device=device)
        p50 = float(np.median(ests))
        out["per_batch"][str(b)] = {
            "p50_ms": p50 * 1e3,
            "p99_ms": float(np.percentile(ests, 99)) * 1e3,
            "qps": b / p50}
    b0 = str(q_batches[0])
    out["q_batch"] = q_batches[0]
    for key in ("p50_ms", "p99_ms", "qps"):
        out[key] = out["per_batch"][b0][key]
    return out


def bench_host_serve(n: int = 67_108_864, d: int = 512, m: int = 64,
                     n_clusters: int = 8192, nprobe: int = 64,
                     depth: int = 400, q_batches: tuple = (1, 8),
                     reps: int = 9,
                     adc_chained_ms: "dict | None" = None,
                     workdir: str | None = None, *, device=None) -> dict:
    """The capacity-serving path, ``IVFPQView.search_host`` (what ``cli
    serve --host-store`` runs): the pruned residual ADC on the card over
    the resident codes, then a host gather of only the ``depth`` candidate
    rows from a memory-mapped int8 ``HostRowStore`` and their exact
    re-score. Per batch, on the host's clock: the end-to-end call, the
    host part alone (gather, re-score, sort over this batch's real
    candidates), the ADC-only call, and one gather after ``rows.bin`` is
    evicted from the page cache (``posix_fadvise(DONTNEED)`` on that file
    alone), which is what a store larger than RAM pays. The store is one
    numpy-drawn random block repeated (gather time does not depend on
    content) and bucket positions a random permutation, so candidate rows
    scatter over the whole file. ``adc_chained_ms`` (per batch, e.g.
    ``bench_ivfpq_capacity``'s p50s) adds ``production_p50_ms``, that ADC
    time plus the host part. Latency only: the quality triple is
    ``bench_ivfpq(host_quality=True)``'s."""
    import shutil
    import tempfile

    from .ops.pq import PQCodebook
    from .search.ivfpq import HostRowStore, IVFPQView, _adc_select

    device = resolve_device(device)
    groups = m // 2
    base = workdir or tempfile.mkdtemp(prefix="instsearch_hostserve_")
    out = {"n": n, "d": d, "m": m, "n_clusters": n_clusters,
           "nprobe": nprobe, "depth": depth,
           "store_gb": round(n * (d + 4) / 2**30, 1), "per_batch": {}}
    try:
        cents, codes, bpos, pqc, qall = _synthetic_ivfpq(
            n, d, m, n_clusters, max(q_batches), 11, device, permute=True)
        view = IVFPQView(cents, codes, bpos, *_no_spill(groups, device),
                         PQCodebook(pqc), nprobe=nprobe, depth=depth)

        # the on-disk store: one random block of at most 262,144 rows,
        # repeated
        spath = os.path.join(base, "store")
        os.makedirs(spath, exist_ok=True)
        rng = np.random.default_rng(0)
        blk_rows = min(n, 262_144)
        blk = rng.integers(-127, 128, size=(blk_rows, d), dtype=np.int8)
        with open(os.path.join(spath, "rows.bin"), "wb") as f:
            done = 0
            while done < n:
                take = min(blk_rows, n - done)
                f.write(blk[:take].tobytes())
                done += take
        np.full((n,), 1.0 / 112.0, np.float32).tofile(
            os.path.join(spath, "scales.bin"))
        with open(os.path.join(spath, "store.json"), "w") as f:
            json.dump({"n": n, "d": d, "dtype": "int8"}, f)
        store = HostRowStore(spath)

        for b in q_batches:
            qb = qall[:b].cpu().numpy()
            view.search_host(store, qb)          # warm
            e2e = []
            for _ in range(reps):
                t0 = time.perf_counter()
                view.search_host(store, qb)
                e2e.append(time.perf_counter() - t0)
            # the host part alone, on this batch's real candidates
            _, pos = _adc_select(*view.arrays, torch.from_numpy(qb).to(
                device), depth=depth, nprobe=nprobe)
            pos = pos.cpu().numpy()
            host = []
            for _ in range(reps):
                t0 = time.perf_counter()
                rows = store.gather(pos)
                exact = np.einsum("bkd,bd->bk", rows, qb, dtype=np.float32)
                np.argsort(-exact, axis=1, kind="stable")
                host.append(time.perf_counter() - t0)
            adc = []
            for _ in range(reps):
                t0 = time.perf_counter()
                view.search_adc(qb)
                adc.append(time.perf_counter() - t0)
            entry = {
                "e2e_p50_ms": float(np.median(e2e)) * 1e3,
                "e2e_p99_ms": float(np.percentile(e2e, 99)) * 1e3,
                "host_gather_rescore_p50_ms": float(np.median(host)) * 1e3,
                "adc_only_e2e_p50_ms": float(np.median(adc)) * 1e3,
                "qps_e2e": b / float(np.median(e2e)),
            }
            chained = (adc_chained_ms or {}).get(str(b))
            if chained is not None:
                entry["production_p50_ms"] = (
                    chained + entry["host_gather_rescore_p50_ms"])
            # cold page cache: evict rows.bin, pay the disk's reads
            try:
                with open(os.path.join(spath, "rows.bin")) as f:
                    os.posix_fadvise(f.fileno(), 0, 0,
                                     os.POSIX_FADV_DONTNEED)
                store_cold = HostRowStore(spath)
                t0 = time.perf_counter()
                store_cold.gather(pos)
                entry["host_gather_cold_ms"] = (
                    (time.perf_counter() - t0) * 1e3)
            except (AttributeError, OSError):
                pass
            out["per_batch"][str(b)] = entry
        b0 = out["per_batch"][str(q_batches[0])]
        out["p50_ms"] = b0["e2e_p50_ms"]
        out["host_gather_rescore_p50_ms"] = b0["host_gather_rescore_p50_ms"]
        if "production_p50_ms" in b0:
            out["production_p50_ms"] = b0["production_p50_ms"]
    finally:
        if workdir is None:
            shutil.rmtree(base, ignore_errors=True)
    return out


def bench_rerank(n: int = 1_048_576, d: int = 512, r: int = 16,
                 depth: int = 100, k: int = 10, q_batch: int = 1,
                 regional_dtype: str = "int8", *, device=None) -> dict:
    """Regional re-ranking of the top ``depth`` with score fusion on the
    device (the composite with ``do_rerank``: K1's top-``depth``, the
    ``[Q, depth, R, D]`` regional gather, the region match, the fused
    top-k). The regional store is R times the index; at the default it is
    int8 with per-(row, region) scales, 8 GiB at 1M rows (bf16 would be
    16). Its content is random (the gather and match do not depend on
    values). The reference stream: the bf16 probe's rate over one scan and
    the gather."""
    from .index import _search_composite

    device = resolve_device(device)
    on_card = device.type == "cuda"
    Xd, q = _make_index_device(n, d, q_batch, device=device)
    ids = torch.arange(n, dtype=torch.int32, device=device)
    if regional_dtype == "int8":
        regional = _random_int8((n, r, d), 1, device)
        reg_scales = 0.004 + 0.006 * torch.rand(
            (n, r), generator=_gen(device, 2), device=device)
    else:
        regional = torch.randn((n, r, d), generator=_gen(device, 1),
                               device=device, dtype=torch.bfloat16)
        reg_scales = None
    qreg = torch.randn((q_batch, r, d), generator=_gen(device, 3),
                       device=device)

    def op(X, ids, qq, regional, reg_scales, qreg):
        return _search_composite(
            X, ids, qq, n, None, regional, reg_scales, qreg, k=k,
            depth=depth, qe_n=0, qe_alpha=3.0, use_kernel=on_card,
            do_qe=False, do_rerank=True)

    args = (Xd, ids, q, regional, reg_scales, qreg)
    scan_bytes = n * d * 2
    gather_bytes = q_batch * depth * r * d * (
        1 if regional_dtype == "int8" else 2)
    out = {"n": n, "d": d, "r": r, "depth": depth, "k": k,
           "q_batch": q_batch, "regional_dtype": regional_dtype,
           "regional_gb": round(regional.numel() * regional.element_size()
                                / 2**30, 2),
           "gather_mb": round(gather_bytes / 2**20, 2)}
    if on_card:
        q1 = torch.ones((1, d), dtype=torch.bfloat16, device=device)
        probe_ests, ests = interleaved_marginal(
            [(make_stream_probe, (Xd, q1)), (_chain(op), args)],
            n1=4, n2=20, device=device)
        out.update(_paired(probe_ests, ests, scan_bytes,
                           scan_bytes + gather_bytes))
    else:
        ests = marginal_times(_chain(op), args, n1=4, n2=20, reps=7,
                              device=device)
    return _latency(out, ests, q_batch)


def bench_lw(n: int = 1_048_576, d: int = 512, e: int = 1024,
             depth: int = 100, k: int = 10, q_batch: int = 1,
             *, device=None) -> dict:
    """Local-whitening re-ranking (``index.py::_lw_composite``): K1's
    top-``depth``, the query whitened by every expert (one ``[B, E, D] x
    [E, dim, D]`` product reading the whole f32 bank), the whitened-store
    gather and the re-score. The bank is e*d*d*4 bytes read once a call,
    whatever B, so B=1 pays all of it and B=32 a 32nd a query. Bank, store
    and assignments are random (timing only)."""
    from .index import _lw_composite
    from .ops.local_whiten import LocalWhiteningParams
    from .search.lw_rerank import LocalWhiteningView

    device = resolve_device(device)
    on_card = device.type == "cuda"
    Xd, q = _make_index_device(n, d, q_batch, device=device)
    ids = torch.arange(n, dtype=torch.int32, device=device)
    P = torch.randn((e, d, d), generator=_gen(device, 5),
                    device=device) * (1.0 / math.sqrt(d))
    mu = torch.randn((e, d), generator=_gen(device, 6), device=device) * 0.01
    store = torch.randn((n, d), generator=_gen(device, 7), device=device,
                        dtype=torch.bfloat16)
    assign = torch.randint(0, e, (n,), generator=_gen(device, 8),
                           device=device, dtype=torch.int32)
    lw = LocalWhiteningView(LocalWhiteningParams(None, P, mu), store, assign)

    def op(X, ids, qq):
        return _lw_composite(X, ids, qq, n, None, lw, k=k, depth=depth,
                             qe_n=0, qe_alpha=3.0, use_kernel=on_card,
                             do_qe=False)

    args = (Xd, ids, q)
    scan_bytes = n * d * 2
    bank_bytes = e * d * d * 4
    gather_bytes = q_batch * depth * d * 2
    out = {"n": n, "d": d, "e": e, "depth": depth, "k": k,
           "q_batch": q_batch,
           "bank_gb": round(bank_bytes / 2**30, 2),
           "store_gb": round(store.numel() * 2 / 2**30, 2)}
    if on_card:
        q1 = torch.ones((1, d), dtype=torch.bfloat16, device=device)
        probe_ests, ests = interleaved_marginal(
            [(make_stream_probe, (Xd, q1)), (_chain(op), args)],
            n1=3, n2=11, device=device)
        out.update(_paired(probe_ests, ests, n * d * 2,
                           scan_bytes + bank_bytes + gather_bytes))
    else:
        ests = marginal_times(_chain(op), args, n1=3, n2=11, reps=7,
                              device=device)
    return _latency(out, ests, q_batch)


def bench_sharded_overhead(n: int = 1_048_576, d: int = 512,
                           k: int = 10, q_batch: int = 1,
                           *, device=None) -> dict:
    """The distribution layer's price: ``ShardedIndex.search`` over a mesh
    of ONE shard (the per-shard kernel, the gather of its candidates, the
    merge) against the bare kernel on the same store, interleaved rep for
    rep."""
    from .kernels.topk_matmul import topk_matmul
    from .parallel import ShardedIndex, make_mesh
    from .search.bruteforce import search_topk

    device = resolve_device(device)
    on_card = device.type == "cuda"
    Xd, q = _make_index_device(n, d, q_batch, device=device)
    ids = torch.arange(n, dtype=torch.int32, device=device)
    sidx = ShardedIndex(Xd, ids, mesh=make_mesh(1, devices=[device]), k=k,
                        use_pallas=on_card)
    bare = topk_matmul if on_card else search_topk
    sharded_ests, plain_ests = interleaved_marginal(
        [(_chain(lambda qq: sidx.search(qq, k=k)), (q,)),
         (_chain(lambda X, qq: bare(X, qq, k=k)),
          (Xd, q.to(torch.bfloat16)))],
        n1=3, n2=11, device=device)
    sp50 = float(np.median(sharded_ests))
    pp50 = float(np.median(plain_ests))
    return {"n": n, "d": d, "k": k, "q_batch": q_batch,
            "sharded_p50_ms": sp50 * 1e3, "plain_p50_ms": pp50 * 1e3,
            "overhead_ms": (sp50 - pp50) * 1e3,
            "overhead_frac": (sp50 - pp50) / pp50 if pp50 > 0 else None}


def bench_protocol_eval(n: int = 105_000, n_queries: int = 70,
                        d: int = 512, depth: int = 100,
                        *, device=None) -> dict:
    """Protocol evaluation's wall clock at Oxford105k's rows (workload 4),
    descriptor level: ``Index.full_ranking`` (the first call and a second
    one), the re-rank head splice (``eval/evaluate.py::_splice_head``, a
    head equal to the ranking's prefix, so the identity) and the ranking
    through a one-shard ``ShardedIndex``, which must equal the index's.
    The rows are numpy-drawn, the reference's numbers."""
    from .config import PipelineConfig, SearchConfig
    from .eval.evaluate import _splice_head
    from .index import Index
    from .parallel import make_mesh

    device = resolve_device(device)
    rng = np.random.default_rng(0)
    X = rng.standard_normal((n, d)).astype(np.float32)
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    cfg = PipelineConfig(search=SearchConfig(k=10, use_pallas=False))
    idx = Index.from_descriptors(X, [f"im{i}" for i in range(n)], cfg,
                                 device=device)
    q = X[:n_queries] + 0.01 * rng.standard_normal(
        (n_queries, d)).astype(np.float32)

    t0 = time.perf_counter()
    ranks = idx.full_ranking(q)
    t_rank = time.perf_counter() - t0
    t0 = time.perf_counter()
    ranks2 = idx.full_ranking(q)          # steady state
    t_rank_warm = time.perf_counter() - t0
    assert np.array_equal(ranks, ranks2)

    top_ids = ranks[:, :depth].copy()     # the worst head: all valid
    t0 = time.perf_counter()
    spliced = _splice_head(ranks, top_ids)
    t_splice = time.perf_counter() - t0
    assert np.array_equal(spliced, ranks)     # head == prefix: identity

    sidx = idx.to_sharded(mesh=make_mesh(1, devices=[idx.device]))
    t0 = time.perf_counter()
    ranks_sh = sidx.full_ranking(q)
    t_rank_sharded = time.perf_counter() - t0
    t0 = time.perf_counter()
    ranks_sh2 = sidx.full_ranking(q)
    t_rank_sharded_warm = time.perf_counter() - t0
    assert np.array_equal(ranks, ranks_sh), "sharded ranking differs"
    assert np.array_equal(ranks_sh, ranks_sh2)

    return {"n": n, "n_queries": n_queries, "d": d,
            "full_ranking_sec": t_rank, "full_ranking_warm_sec": t_rank_warm,
            "splice_sec": t_splice, "full_ranking_sharded_sec": t_rank_sharded,
            "full_ranking_sharded_warm_sec": t_rank_sharded_warm,
            "total_warm_sec": t_rank_warm + t_splice}


def bench_query_e2e(n: int = 1_048_576, d: int = 512, k: int = 10,
                    image_size: int = 224, backbone: str = "resnet50",
                    pooling: str = "gem", *, device=None) -> dict:
    """Image -> result latency for one image: extraction (backbone,
    pooling), the whitening projection to the store's width and L2, then
    the fused top-k (K1) over a 1M-row bf16 store, as one chained op. At
    B=1 the extraction leads."""
    from .kernels.topk_matmul import topk_matmul
    from .models.registry import descriptor_dim
    from .ops.whitening import WhiteningParams, apply_whitening
    from .search.bruteforce import search_topk

    device = resolve_device(device)
    on_card = device.type == "cuda"
    cfg = ExtractConfig(backbone=backbone, pooling=pooling,
                        image_size=image_size, dtype="bfloat16")
    model, extract = build_extract_fn(cfg, device=device)
    model.init_weights(_gen(device, 0))
    feat_dim = descriptor_dim(cfg)
    # the whitening projection feat_dim -> d (random: timing only)
    wp = WhiteningParams(
        P=torch.from_numpy((np.random.default_rng(0).standard_normal(
            (d, feat_dim)).astype(np.float32) / np.sqrt(feat_dim)).astype(
            np.float32)).to(device),
        mu=torch.zeros((feat_dim,), device=device))
    Xd = _unit(torch.randn((n, d), generator=_gen(device, 1),
                           device=device)).to(torch.bfloat16)
    img = torch.from_numpy(np.random.default_rng(2).random(
        (1, image_size, image_size, 3), dtype=np.float32) * 255.0).to(device)
    search = topk_matmul if on_card else search_topk

    def op(Xd, img):
        q = apply_whitening(extract(img), wp)
        return search(Xd, q.to(torch.bfloat16), k=k)

    ests = marginal_times(_chain(op), (Xd, img), n1=3, n2=15, reps=7,
                          device=device)
    p50 = float(np.median(ests))
    return {
        "p50_ms": p50 * 1e3,
        "p99_ms": float(np.percentile(ests, 99)) * 1e3,
        "n": n, "d": d, "k": k, "image_size": image_size,
        "backbone": backbone, "pooling": pooling,
    }


def bench_train(batch: int = 16, negs: int = 1, image_size: int = 224,
                backbone: str = "resnet50", *, device=None) -> dict:
    """Fine-tuning step throughput: forward, backward and AdamW over
    (anchor, positive, negatives) tuples in bf16 (``Trainer.step``).
    ``Trainer.step`` reads its loss on the host, so each chain is timed by
    the host's clock around a synchronize. The chain steps one trainer on
    (the weights move; a step's time does not depend on them)."""
    from .config import TrainConfig
    from .train import Trainer

    device = resolve_device(device)
    cfg = TrainConfig(backbone=backbone, pooling="gem", batch_size=batch,
                      num_negatives=negs, image_size=image_size,
                      dtype="bfloat16")
    tr = Trainer(cfg, seed=0, device=device)
    t = 2 + negs
    imgs = torch.from_numpy((np.random.default_rng(0).random(
        (batch, t, image_size, image_size, 3)) * 255).astype(np.uint8)).to(
        device)

    ests = marginal_times(_chain(tr.step), (imgs,), n1=3, n2=11, reps=5,
                          device=device, wall=True)
    p50 = float(np.median(ests))
    return {"steps_per_sec": 1.0 / p50, "step_ms": p50 * 1e3,
            "tuple_images_per_sec": batch * t / p50,
            "batch": batch, "tuple": t, "image_size": image_size,
            "backbone": backbone}


def _kernel_launches() -> dict:
    """Every hand-written kernel's launch count so far in this process."""
    from . import kernels
    return {name: getattr(kernels, name).launches for name in (
        "topk_matmul", "topk_matmul_int8", "topk_matmul_int4", "pq_topk",
        "mha", "flash_mha", "fused_identity_blocks")}


def _stage(out: dict, key: str, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, with its kernels' launches (in
    ``out["kernel_launches"][key]``) and, on the card, its peak device
    memory (``out["peak_gib"][key]``, ``torch.cuda.max_memory_allocated``
    from a reset before it); one line of both on stderr. The stage's
    tensors are gone when it returns, and the allocator's cache is emptied
    before the next."""
    device = kwargs["device"]
    before = _kernel_launches()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    res = fn(*args, **kwargs)
    wall = time.perf_counter() - t0
    after = _kernel_launches()
    launches = {k: after[k] - before[k] for k in after if after[k] > before[k]}
    out.setdefault("kernel_launches", {})[key] = launches
    line = {"stage": key, "wall_sec": round(wall, 3), "launches": launches}
    if device.type == "cuda":
        peak = torch.cuda.max_memory_allocated(device) / 2**30
        out.setdefault("peak_gib", {})[key] = round(peak, 3)
        line["peak_gib"] = round(peak, 3)
        gc.collect()
        torch.cuda.empty_cache()
    print(json.dumps(line), file=sys.stderr, flush=True)
    return res


def run_bench(what: str = "all", *, device=None) -> dict:
    """The reference's groups: ``extraction``, ``query``, ``all`` (both) and
    ``extended`` (the extraction sweep, the 4M-row int8 and 8M-row int4
    capacity queries, ``dba_1M``, ``ivf_1M``, ``pq_1M``, ``train``), each at
    the reference's sizes. Beside the reference's keys:
    ``kernel_launches`` (each stage's launches of the hand-written kernels)
    and, on the card, ``peak_gib`` (each stage's peak device memory)."""
    device = resolve_device(device)
    on_card = device.type == "cuda"
    out: dict = {"platform": device.type,
                 "device": (torch.cuda.get_device_name(device) if on_card
                            else "cpu")}
    kw = {"device": device}
    if what in ("extraction", "all"):
        out["extraction"] = _stage(out, "extraction", bench_extraction, **kw)
        out["extraction_e2e"] = _stage(out, "extraction_e2e",
                                       bench_extraction_e2e, **kw)
    if what in ("query", "all"):
        for key, qkw in (("query", {}), ("query_b128", {"q_batch": 128}),
                         ("query_int8", {"dtype": "int8"}),
                         ("query_int8_b128", {"q_batch": 128,
                                              "dtype": "int8"}),
                         ("query_int4", {"dtype": "int4"}),
                         ("query_int4_b128", {"q_batch": 128,
                                              "dtype": "int4"})):
            out[key] = _stage(out, key, bench_query, **qkw, **kw)
        out["query_filtered"] = _stage(out, "query_filtered",
                                       bench_filtered_query, **kw)
        out["query_e2e"] = _stage(out, "query_e2e", bench_query_e2e, **kw)
        if "hbm_bw_gbps" in out["query"]:   # absent on the CPU
            out["hbm_bw_gbps"] = out["query"]["hbm_bw_gbps"]
        # QPS against the store's rows; the 1M point is the one above
        out["query_sweep"] = [
            _stage(out, f"query_sweep_{nn}", bench_query, n=nn, **kw)
            for nn in (65_536, 262_144)] + [out["query"]]
        # the quality stack at 1M rows, the distribution layer's price and
        # the 105k protocol evaluation
        for key, fn, skw in (
                ("qe", bench_qe, {}), ("qe_b128", bench_qe, {"q_batch": 128}),
                ("rerank", bench_rerank, {}),
                ("rerank_b32", bench_rerank, {"q_batch": 32}),
                ("diffusion", bench_diffusion, {}),
                ("refine", bench_refine, {}), ("lw", bench_lw, {}),
                ("lw_b32", bench_lw, {"q_batch": 32}),
                ("sharded_overhead", bench_sharded_overhead, {}),
                ("protocol_eval_105k", bench_protocol_eval, {})):
            out[key] = _stage(out, key, fn, **skw, **kw)
    if what == "extended":
        # every backbone and pooling family of the presets, then the
        # capacity on one card: 4M int8 rows, 8M int4 rows
        out["extraction_sweep"] = [
            _stage(out, f"extraction_sweep_{i}", bench_extraction, **skw,
                   **kw)
            for i, skw in enumerate((
                {"backbone": "resnet50", "pooling": "gem"},
                {"backbone": "resnet50", "pooling": "rmac"},
                {"backbone": "vgg16", "pooling": "mac"},
                {"backbone": "resnet101", "pooling": "gem"},
                {"backbone": "resnet50", "pooling": "gem",
                 "scales": (1.0, 0.7071, 0.5)},
                # ViT at its default attention route ("auto")
                {"backbone": "vit_b_16", "pooling": "gem"}))]
        out["query_capacity_int8_4M"] = _stage(
            out, "query_capacity_int8_4M", bench_query, n=4_194_304,
            dtype="int8", **kw)
        out["query_capacity_int4_8M"] = _stage(
            out, "query_capacity_int4_8M", bench_query, n=8_388_608,
            dtype="int4", **kw)
        out["dba_1M"] = _stage(out, "dba_1M", bench_dba, **kw)
        out["ivf_1M"] = _stage(out, "ivf_1M", bench_ivf, **kw)
        out["pq_1M"] = _stage(out, "pq_1M", bench_pq, **kw)
        out["train"] = _stage(out, "train", bench_train, **kw)
    return out
