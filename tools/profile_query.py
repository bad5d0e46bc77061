#!/usr/bin/env python3
"""Where an image query's device time goes: ``torch.profiler`` over the
port's ``Index.query_images`` on one GPU.

    python3 tools/profile_query.py [--rows 1048576] [--corpus 1024]
                                   [--batches 1 8 128] [--reps 10]
                                   [--config configs/capacity_int4.json]
                                   [--config configs/oxford105k_sharded8.json
                                    --rows 105133 --corpus 4096]
                                   [--backbone vit_b_16]
                                   [--vit-attention pallas|flash|xla]
    python3 tools/profile_query.py --resnet-route module|fused|fused_all
                                   [--batches 64] [--reps 10]

Run from the root of a checkout. It builds the configuration of
chip_smoke.py's phase 2 (seeded random ResNet-50 at 224 px, bf16, GeM,
whitening to 512; a bf16 store), or with ``--backbone vit_b_16`` that of
phase 5 (ViT-B/16 on the ``--vit-attention`` route), or the preset
``--config`` names (phase 3's and 9's stand-ins), with ``--rows`` rows:
``--corpus`` extracted seeded images, the rest seeded unit distractor rows
(a preset that whitens at full width needs a corpus wider than its
descriptors). A preset of several shards holds them all on cuda:0
(``make_mesh(S, devices=["cuda"] * S)``), and each batch size is profiled
through the sharded index (``route: "sharded"``) and on one device
(``route: "single device"``). For each query batch size B (and route) it
prints one JSON line with, per query batch:

  * ``kernels``: device operations (kernels and copies) launched;
  * ``busy_ms``: the sum of their durations, and its split into
    convolution/GEMM, BatchNorm, LayerNorm, softmax, the port's attention
    kernels (K5/K6), sorts (the sharded merges, the re-rank's selection),
    other elementwise, copies, top-k pass 1 and top-k pass 2;
  * ``wall_ms``: host time under the profiler, and ``wall_p50_ms`` without
    it; ``idle`` and ``idle_unprofiled``: 1 - busy / each wall;
  * with a re-rank preset (``configs/rerank_regional_top100.json``,
    ``configs/spatial_rerank_top100.json``): the store also carries a
    regional store ``[rows, 14, dim]`` bf16 on the card (the corpus's
    regional rows from one combined pass, seeded unit rows for the rest),
    and ``rerank_<part>_ms`` is the device time of the kernels launched in
    each part of the re-rank stage (``search/rerank.py``'s profiler ranges:
    ``gather``, the candidates' regions gathered and widened to f32;
    ``products``, the region products; ``match``; ``vote``, the spatial
    vote; ``select``, the fused top-k). Those kernels are also in the
    categories above.

``--resnet-route`` profiles the ResNet-50 backbone forward alone at 224 px
instead (chip_smoke.py phase 6: seeded weights, randomized BatchNorm): the
module (cuDNN, BN unfolded), ``fused_resnet_apply`` with the default
``fused_layers=(2,)`` (``fused``) or ``(1, 2, 3, 4)`` (``fused_all``), the
identity blocks it fuses in the ``fused_blocks`` category (K7).

Every line carries the card's nvidia-smi name and power limit.
"""
from __future__ import annotations

import argparse
import os
import statistics
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import (IMAGE, card_line, regional_unit_rows,  # noqa: E402
                        report, smooth_images)
from instsearch_torch import (ExtractConfig, IndexConfig,  # noqa: E402
                              PipelineConfig, SearchConfig)
from instsearch_torch.extractor import Extractor  # noqa: E402
from instsearch_torch.index import Index, attach_regional_store  # noqa: E402
from instsearch_torch.ops.whitening import (apply_whitening,  # noqa: E402
                                            fit_whitening)
from instsearch_torch.parallel import make_mesh  # noqa: E402

DIM = 512


def category(name: str) -> str:
    """Device operation name -> the profile's category."""
    low = name.lower()
    if "topk_pass1" in low:
        return "topk_pass1"
    if "topk_pass2" in low:
        return "topk_pass2"
    if low.startswith(("memcpy", "memset")):
        return "copies"
    if "bn_" in low or "batch_norm" in low or "batchnorm" in low:
        return "batchnorm"
    if "mha_kernel" in low or "flash_kernel" in low:
        return "attention_kernel"
    if "identity_block_kernel" in low:
        return "fused_blocks"
    if "layer_norm" in low:
        return "layernorm"
    if "sort" in low:
        return "sort"
    if "softmax" in low:
        return "softmax"
    if any(w in low for w in ("conv", "xmma", "implicit", "fprop", "gemm",
                              "cutlass", "cudnn", "nhwc", "nchw", "nvjet")):
        return "conv_gemm"
    return "elementwise"


PHASE2 = PipelineConfig(
    extract=ExtractConfig(backbone="resnet50", pooling="gem", gem_p=3.0,
                          image_size=IMAGE, whiten=True, whiten_dim=DIM,
                          dtype="bfloat16", batch_size=64),
    index=IndexConfig(dtype="bfloat16"), search=SearchConfig(k=10))


def build_index(gen, rows: int, corpus: int, cfg: PipelineConfig):
    """(index, the corpus's uint8 images); with ``rerank_enabled`` the index
    carries a regional store."""
    ex = Extractor(cfg.extract.replace(whiten=False), seed=0, device="cuda")
    images = smooth_images(gen, corpus, size=cfg.extract.image_size)
    bs = cfg.extract.batch_size
    rerank = cfg.search.rerank_enabled
    outs = [ex.extract_with_regional(images[s:s + bs]) if rerank
            else (ex(images[s:s + bs]), None) for s in range(0, corpus, bs)]
    raw = torch.cat([g for g, _ in outs])
    ex.whitening = fit_whitening(raw, dim=cfg.extract.whiten_dim or None)
    dim = ex.whitening.P.shape[0]
    distract = torch.randn(rows - corpus, dim, generator=gen, device="cuda")
    distract = distract / distract.norm(dim=1, keepdim=True)
    store = torch.cat([apply_whitening(raw, ex.whitening), distract])
    names = [f"row{i:07d}" for i in range(rows)]
    idx = Index.from_descriptors(store, names, cfg, extractor=ex)
    if rerank:
        reg_raw = torch.cat([r for _, r in outs])
        reg = torch.empty((rows, reg_raw.shape[1], dim), dtype=torch.bfloat16,
                          device="cuda")
        reg[:corpus] = apply_whitening(reg_raw, ex.whitening)
        regional_unit_rows(gen, rows, corpus, reg)
        attach_regional_store(idx, reg)
    return idx, images




def profile_calls(call, reps: int) -> dict:
    """Profile ``reps`` calls of ``call``, which returns once its device
    work is done (a query's host copy of its results, or a synchronize)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        call()                                        # warm this shape
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        call()
        walls.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / reps
    split: dict[str, float] = {}
    parts: dict[str, float] = {}
    count = 0
    for e in prof.events():
        if getattr(e, "is_user_annotation", False):
            if (e.device_type == DeviceType.CPU
                    and e.name.startswith("rerank.")):
                part = f"rerank_{e.name.split('.', 1)[1]}_ms"
                parts[part] = parts.get(part, 0.0) + getattr(
                    e, "device_time_total", 0.0) / 1e3
            continue
        if e.device_type != DeviceType.CUDA:
            continue
        count += 1
        cat = category(e.name)
        split[cat] = split.get(cat, 0.0) + e.time_range.elapsed_us() / 1e3
    if count == 0:
        raise RuntimeError("the profiler recorded no device operation")
    busy = sum(split.values()) / reps
    return {"kernels": count / reps, "busy_ms": busy,
            **{f"{c}_ms": v / reps for c, v in sorted(split.items())},
            **{p: v / reps for p, v in sorted(parts.items())},
            "wall_ms": wall, "wall_p50_ms": statistics.median(walls),
            "idle": 1 - busy / wall,
            "idle_unprofiled": 1 - busy / statistics.median(walls)}


RESNET_ROUTES = {"module": None, "fused": (2,), "fused_all": (1, 2, 3, 4)}


def resnet_call(route: str, gen, b: int):
    """A call of ResNet-50's forward on ``route`` over b seeded images."""
    from instsearch_torch.data.frontend import normalize
    from instsearch_torch.kernels.fused_resnet import (STAGE_SIZES,
                                                       fused_resnet_apply,
                                                       randomize_bn)
    from instsearch_torch.models import get_backbone
    model = get_backbone("resnet50")[0].init_weights(gen)
    randomize_bn(model, gen)
    x = normalize(torch.from_numpy(smooth_images(gen, b)).cuda())
    sd = model.state_dict()
    layers = RESNET_ROUTES[route]

    @torch.inference_mode()
    def call():
        if layers is None:
            model(x)
        else:
            fused_resnet_apply(sd, x, STAGE_SIZES["resnet50"],
                               fused_layers=layers)
        torch.cuda.synchronize()
    return call


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=1 << 20)
    ap.add_argument("--corpus", type=int, default=1024)
    ap.add_argument("--batches", type=int, nargs="+", default=[1, 8, 128])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--config", default=None,
                    help="a preset of configs/ (with its shards)")
    ap.add_argument("--backbone", default=PHASE2.extract.backbone)
    ap.add_argument("--vit-attention", default="pallas",
                    choices=("auto", "xla", "pallas", "flash"))
    ap.add_argument("--resnet-route", choices=sorted(RESNET_ROUTES),
                    help="profile the ResNet-50 forward on this route alone")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_query: needs a CUDA device")
    card = card_line()
    print(card, flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    if args.resnet_route:
        for b in args.batches:
            report(card, resnet_route=args.resnet_route, image=IMAGE, b=b,
                   reps=args.reps, **profile_calls(
                       resnet_call(args.resnet_route, gen, b), args.reps))
        return 0
    cfg = PHASE2.replace(extract=PHASE2.extract.replace(
        backbone=args.backbone, vit_attention=args.vit_attention))
    if args.config:
        cfg = PipelineConfig.load(args.config)
    idx, images = build_index(gen, args.rows, args.corpus, cfg)
    shards = cfg.index.num_shards
    routes = [("single device", None)]
    if shards > 1:
        routes.insert(0, ("sharded", idx.to_sharded(
            mesh=make_mesh(shards, devices=["cuda"] * shards))))
    rng = np.random.default_rng(0)
    for b in args.batches:
        batch = images[rng.choice(args.corpus, size=b,
                                  replace=b > args.corpus)]
        for route, sidx in routes:
            report(card, config=args.config or "chip_smoke phase 2",
                   backbone=cfg.extract.backbone,
                   vit_attention=cfg.extract.vit_attention,
                   store=cfg.index.dtype, qe=cfg.search.qe_enabled,
                   rerank=cfg.search.rerank_enabled,
                   spatial_weight=cfg.search.spatial_weight,
                   shards=shards, route=route, rows=args.rows, b=b,
                   reps=args.reps, **profile_calls(
                       lambda: idx.query_images(batch, sharded_index=sidx),
                       args.reps))
    return 0


if __name__ == "__main__":
    sys.exit(main())
