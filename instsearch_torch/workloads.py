"""Run every committed workload preset end to end (port of
``instsearch_tpu/workloads.py``): every ``configs/*.json`` — build ->
(whiten) -> query/QE/re-rank -> protocol metrics, with the reference's
result keys.

``scale_down`` shrinks image size and batch so the suite runs on the mini
fixture; the config's structure (backbone, pooling, whitening, QE,
sharding, re-ranking) is exercised unchanged. A preset with shards keeps
its shard count: the reference cuts it to its device count because a JAX
mesh holds one shard a device, where the port's ``ShardMesh`` lays several
shards on one device, so on fewer cards than shards they go to the cards
in turn (all on one card on a one-card machine). Everything runs on
``device``, the CUDA card by default.
"""
from __future__ import annotations

import glob
import os
import time

import torch

from .config import PipelineConfig
from .eval.datasets import RetrievalDataset, load_dataset
from .eval.evaluate import evaluate_index, extract_queries
from .index import Index
from .parallel import device_mesh
from .utils.device import resolve_device

PRESET_DIR = os.path.join(os.path.dirname(__file__), "..", "configs")


def list_presets() -> list[str]:
    return sorted(
        os.path.splitext(os.path.basename(p))[0]
        for p in glob.glob(os.path.join(PRESET_DIR, "*.json")))


def load_preset(name: str) -> PipelineConfig:
    return PipelineConfig.load(os.path.join(PRESET_DIR, name + ".json"))


def _scaled(cfg: PipelineConfig, image_size: int, batch: int
            ) -> PipelineConfig:
    # index.capacity is left as shipped (0: size to the dataset), so small
    # runs take the same padding and capacity code path
    return PipelineConfig(
        extract=cfg.extract.replace(image_size=image_size, batch_size=batch),
        index=cfg.index, search=cfg.search, eval=cfg.eval)


def run_workload(name: str, dataset: RetrievalDataset,
                 scale_down: bool = True, seed: int = 0,
                 *, device: "torch.device | str | None" = None) -> dict:
    device = resolve_device(device)
    cfg = load_preset(name)
    if scale_down:
        cfg = _scaled(cfg, image_size=64, batch=8)
    shards = cfg.index.num_shards

    t0 = time.time()
    idx = Index.build(dataset.db_paths, cfg, seed=seed, device=device)
    if cfg.search.lw_enabled:
        # the local-whitening view is a post-build fit; expert count
        # defaults to ~sqrt(N)
        idx.fit_local_whitening(seed=seed)
    if cfg.search.ivfpq_nprobe > 0:
        # the candidate tier is a post-build fit too (~sqrt(N) clusters,
        # D/8 subspaces); the protocol metrics below rank the full index
        # exactly, so the tier shows in the recall guard, not in mAP
        idx.build_ivfpq(nprobe=cfg.search.ivfpq_nprobe, seed=seed)
    build_s = time.time() - t0

    protocol = cfg.eval.protocol if dataset.name != "mini" else "medium"
    scfg = cfg.search
    rescoring_on = (scfg.rerank_enabled or scfg.refine_enabled
                    or scfg.diffusion_enabled or scfg.lw_enabled
                    or scfg.spatial_weight > 0)
    res = evaluate_index(idx, dataset, protocol, include_ranks=True)

    out = {
        "workload": name,
        "backbone": cfg.extract.backbone,
        "pooling": cfg.extract.pooling,
        "whiten": cfg.extract.whiten,
        "scales": list(cfg.extract.scales),
        "qe": cfg.search.qe_enabled,
        "rerank": cfg.search.rerank_enabled,
        "spatial": cfg.search.spatial_weight > 0,
        "lw": cfg.search.lw_enabled,
        "num_shards": shards,
        "num_images": idx.num_valid,
        "descriptor_dim": idx.dim,
        "build_sec": round(build_s, 2),
        "mAP": round(res["mAP"], 2),
    }
    if scfg.ivfpq_nprobe > 0:
        # the candidate tier's guard: the view exists and serves
        # Index.search, its recall measured on the dataset's own query
        # descriptors (out of sample for the indexed rows)
        if idx.ivfpq is None:
            raise RuntimeError(f"{name}: build_ivfpq attached no view")
        qv = extract_queries(idx, dataset)
        qv = idx._match_query_dim(torch.as_tensor(qv, device=idx.device))
        rec = idx.ivfpq.measure_recall(idx, qv, k=min(10, idx.num_valid))
        out["ivfpq"] = True
        out["ivfpq_recall_at_10"] = round(float(rec), 3)
    for key in ("mP@1", "mP@5", "mP@10"):
        if key in res:
            out[key] = round(res[key], 2)

    # stage-dropout guard: every stage the preset enables must appear in
    # evaluate's record, and a rank-moving stage must change the ranking
    # against the all-stages-off config
    enabled = [nm for nm, on in (("qe", scfg.qe_enabled),
                                 ("rerank", scfg.rerank_enabled),
                                 ("spatial", scfg.spatial_weight > 0),
                                 ("refine", scfg.refine_enabled),
                                 ("diffusion", scfg.diffusion_enabled),
                                 ("lw", scfg.lw_enabled)) if on]
    out["stages_missing"] = sorted(set(enabled)
                                   - set(res["stages_applied"]))
    if rescoring_on:
        off = scfg.replace(rerank_enabled=False, refine_enabled=False,
                           diffusion_enabled=False, lw_enabled=False,
                           spatial_weight=0.0)
        res_off = evaluate_index(idx, dataset, protocol, off,
                                 include_ranks=True)
        out["mAP_rescoring_off"] = round(res_off["mAP"], 2)
        out["rescoring_changed_ranking"] = bool(
            (res["ranks"] != res_off["ranks"]).any())

    if shards > 1:
        # the sharded presets compute their protocol metrics through the
        # sharded machinery too, and must rank exactly as one device
        sidx = idx.to_sharded(mesh=device_mesh(shards, idx.device))
        res_sharded = evaluate_index(idx, dataset, protocol,
                                     sharded_index=sidx,
                                     include_ranks=True)
        out["mAP_sharded"] = round(res_sharded["mAP"], 2)
        out["sharded_matches_single"] = bool(
            abs(res_sharded["mAP"] - res["mAP"]) < 1e-6
            and (res_sharded["ranks"] == res["ranks"]).all())
    return out


def run_all(data_root: str = "data", dataset_name: str = "mini",
            scale_down: bool = True,
            *, device: "torch.device | str | None" = None) -> list[dict]:
    device = resolve_device(device)
    dataset = load_dataset(dataset_name, data_root)
    return [run_workload(name, dataset, scale_down, device=device)
            for name in list_presets()]
