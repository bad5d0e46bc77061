"""Command-line interface of the port (port of ``instsearch_tpu/cli.py``:
its subcommands, options and output JSON, key for key).

    python -m instsearch_torch.cli build-index --images DIR --out IDX
    python -m instsearch_torch.cli query --index IDX --image IMG [-k 10]
    python -m instsearch_torch.cli evaluate --dataset mini [--config F]
    python -m instsearch_torch.cli serve --index IDX [--port N]
    python -m instsearch_torch.cli --device cpu workloads

One option the reference does not have: ``--device`` (before or after the
subcommand), where the work runs, the port's counterpart of
``JAX_PLATFORMS``. It defaults to the CUDA card; without one, every
subcommand that touches tensors exits with code 2 and says so, and never
carries on on the CPU unless ``--device cpu`` asks for it.

``finetune`` writes the port's checkpoint (``utils/checkpoint.py``: a
directory holding ``torch_weights.pt``) and the reference's sidecars beside
it, ``<out>.meta.json`` (``gem_p``, ``backbone``, ``pooling``,
``image_size``, ``whitening``) and, with ``--fit-lw``,
``<out>.whitening.npz``; ``build-index --weights`` and ``evaluate
--weights`` read it.

Refused with exit code 2: ``bench``, with a message naming the ROADMAP
item (M10a, the port's benchmark), and ``--weights`` given an orbax tree,
with a message naming ``tools/orbax_to_port.py``, which converts a
``finetune`` checkpoint the JAX package wrote into the port's form where JAX
and orbax are installed (a torchvision ``.pth``/``.pt`` checkpoint is
imported by ``models/torch_import.py``).
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys

from .config import PipelineConfig
from .utils.device import resolve_device


def _load_cfg(args) -> PipelineConfig:
    cfg = PipelineConfig.load(args.config) if args.config else PipelineConfig()
    if getattr(args, "backbone", None):
        cfg = PipelineConfig(
            extract=cfg.extract.replace(backbone=args.backbone),
            index=cfg.index, search=cfg.search, eval=cfg.eval)
    return cfg


def _error(msg: str) -> int:
    print(f"error: {msg}", file=sys.stderr)
    return 2


def _image_paths(folder: str) -> list[str]:
    return (sorted(glob.glob(os.path.join(folder, "*.jpg")))
            + sorted(glob.glob(os.path.join(folder, "*.png"))))


def _members(spec: str) -> list[str]:
    """``NAMES`` comma-separated, or ``@FILE`` with one name per line."""
    if spec.startswith("@"):
        with open(spec[1:]) as f:
            return [ln.strip() for ln in f if ln.strip()]
    return [s for s in spec.split(",") if s]


def _view_params(idx) -> dict:
    """The attached views' sizing, to fit them again over mutated rows."""
    def opq(view):
        return 8 if view.rotation is not None else 0

    return {
        "ivf": ((idx.ivf.n_clusters, idx.ivf.nprobe)
                if idx.ivf is not None else None),
        "lw": idx.lw.n_clusters if idx.lw is not None else None,
        "pq": ((idx.pq.m, idx.pq.depth, opq(idx.pq), idx.pq.anisotropic_t)
               if idx.pq is not None else None),
        "ivfpq": ((idx.ivfpq.n_clusters, idx.ivfpq.nprobe, idx.ivfpq.m,
                   idx.ivfpq.depth, opq(idx.ivfpq), idx.ivfpq.anisotropic_t)
                  if idx.ivfpq is not None else None),
    }


def _refit_views(idx, params: dict) -> None:
    """Fit every view of ``params`` again over the index's current rows."""
    if params["ivf"] is not None:
        c, nprobe = params["ivf"]
        idx.build_ivf(n_clusters=min(c, idx.num_valid), nprobe=nprobe)
    if params["lw"] is not None:
        idx.fit_local_whitening(n_clusters=min(params["lw"], idx.num_valid))
    if params["pq"] is not None:
        m, depth, opq_iters, apq_t = params["pq"]
        idx.build_pq(m=m, depth=depth, opq_iters=opq_iters,
                     anisotropic_t=apq_t)
    if params["ivfpq"] is not None:
        c, nprobe, m, depth, opq_iters, apq_t = params["ivfpq"]
        idx.build_ivfpq(n_clusters=min(c, idx.num_valid), nprobe=nprobe,
                        m=m, depth=depth, opq_iters=opq_iters,
                        anisotropic_t=apq_t)


def _finetuned(path: str, cfg: PipelineConfig, device):
    """A ``finetune`` checkpoint -> ``(cfg, variables, whitening)``: the
    sidecar's ``gem_p``, backbone, pooling and image size applied to the
    extraction config, and its Lw whitening (which replaces the PCA fit)
    on ``device``. Raises ``FileNotFoundError`` when a recorded whitening
    sidecar is missing, ``NotImplementedError`` for an orbax tree (its
    message names ``tools/orbax_to_port.py``)."""
    import numpy as np
    import torch

    from .ops.whitening import WhiteningParams
    from .utils.checkpoint import load_pytree
    variables = load_pytree(path)
    whitening = None
    meta_path = path + ".meta.json"
    if os.path.exists(meta_path):
        with open(meta_path) as fh:
            wmeta = json.load(fh)
        ex = cfg.extract
        cfg = cfg.replace(extract=ex.replace(
            backbone=wmeta.get("backbone", ex.backbone),
            pooling=wmeta.get("pooling", ex.pooling),
            gem_p=wmeta.get("gem_p", ex.gem_p),
            image_size=wmeta.get("image_size", ex.image_size)))
        if wmeta.get("whitening"):
            # a relative path is the sidecar's name beside the meta file
            wpath = wmeta["whitening"]
            if not os.path.isabs(wpath):
                wpath = os.path.join(os.path.dirname(
                    os.path.abspath(meta_path)), os.path.basename(wpath))
            if not os.path.exists(wpath):
                raise FileNotFoundError(
                    f"whitening sidecar {wmeta['whitening']} recorded by "
                    f"finetune --fit-lw not found (looked at {wpath})")
            raw = np.load(wpath)
            whitening = WhiteningParams(
                P=torch.from_numpy(raw["P"]).to(device),
                mu=torch.from_numpy(raw["mu"]).to(device))
    return cfg, variables, whitening


def cmd_build_index(args) -> int:
    from .index import Index
    cfg = _load_cfg(args)
    if args.dba_n:
        cfg = cfg.replace(index=cfg.index.replace(
            dba_n=args.dba_n, dba_alpha=args.dba_alpha))
    variables = whitening = None
    if args.weights:
        try:
            cfg, variables, whitening = _finetuned(args.weights, cfg,
                                                   args.device)
        except (NotImplementedError, FileNotFoundError) as e:
            return _error(str(e))
    if args.pq and args.ivf:
        # both views would arm both candidate tiers in the saved config
        return _error("--ivf and --pq are mutually exclusive candidate "
                      "tiers; pick one")
    if args.ivfpq and (args.ivf or args.pq):
        return _error("--ivfpq is mutually exclusive with --ivf/--pq "
                      "(one candidate-selection tier per index)")
    paths = _image_paths(args.images)
    if not paths:
        return _error(f"no images found under {args.images}")
    if args.resumable:
        from .builder import ResumableBuilder
        b = ResumableBuilder(paths, cfg, args.out + ".build",
                             variables=variables, device=args.device)
        b.run()
        idx = b.finalize(whitening=whitening)
    else:
        idx = Index.build(paths, cfg, variables=variables,
                          whitening=whitening, device=args.device)
    out = {"indexed": idx.num_valid, "quarantined": len(idx.quarantined),
           "dim": idx.dim, "out": args.out}
    if cfg.index.dba_n:
        out["dba_n"] = cfg.index.dba_n
    if args.ivf:
        ivf = idx.build_ivf(n_clusters=args.ivf_clusters or None,
                            nprobe=args.nprobe)
        out["ivf"] = {"clusters": ivf.n_clusters, "nprobe": ivf.nprobe,
                      "scan_fraction": round(ivf.scan_fraction(), 4)}
    if args.lw:
        lw = idx.fit_local_whitening(n_clusters=args.lw_clusters or None)
        out["lw"] = {"clusters": lw.n_clusters, "dim": lw.dim}
    if args.pq:
        pq = idx.build_pq(m=args.pq_m or None, depth=args.pq_depth,
                          opq_iters=args.opq_iters,
                          anisotropic_t=args.apq_t or None)
        out["pq"] = {"m": pq.m, "bytes_per_row": pq.bytes_per_row,
                     "depth": pq.depth, "opq": pq.rotation is not None,
                     "anisotropic_t": pq.anisotropic_t}
    if args.ivfpq:
        v = idx.build_ivfpq(n_clusters=args.ivf_clusters or None,
                            nprobe=args.nprobe, m=args.pq_m or None,
                            depth=args.pq_depth, opq_iters=args.opq_iters,
                            anisotropic_t=args.apq_t or None)
        out["ivfpq"] = {"clusters": v.n_clusters, "nprobe": v.nprobe,
                        "m": v.m, "bytes_per_row": v.bytes_per_row,
                        "depth": v.depth, "opq": v.rotation is not None,
                        "anisotropic_t": v.anisotropic_t,
                        "scan_fraction": round(v.scan_fraction(), 4)}
    idx.save(args.out)
    print(json.dumps(out))
    return 0


def cmd_update_index(args) -> int:
    """Offline index maintenance: add images and remove names on a saved
    index, in place (the server's ``add``/``remove`` requests offline).
    Attached views are fitted again over the final rows."""
    from .index import Index
    idx = Index.load(args.index, device=args.device)
    params = _view_params(idx)
    added = removed = 0
    if args.remove:
        removed = idx.remove(args.remove)
    if args.add:
        paths = []
        for p in args.add:
            paths += _image_paths(p) if os.path.isdir(p) else [p]
        if not paths:
            return _error(f"no images found in {args.add}")
        if idx.extractor is None:
            return _error("index has no extractor weights; cannot extract "
                          "new images")
        added = idx.add(paths=paths)
    if added or removed:
        # add() absorbs views the way a live server must; offline, a fresh
        # fit over the final rows is better (and remove() drops some)
        _refit_views(idx, params)
    idx.save(args.out or args.index)
    print(json.dumps({"added": added, "removed": removed,
                      "rows": idx.num_valid,
                      "out": args.out or args.index}))
    return 0


def cmd_merge_index(args) -> int:
    """Offline union of independently built indexes (``Index.merge_from``):
    one extraction pipeline, disjoint names; the first index's views are
    fitted again over the union and its dtype and capacity rules apply."""
    from .index import Index
    idx = Index.load(args.indexes[0], device=args.device)
    params = _view_params(idx)
    merged = 0
    for path in args.indexes[1:]:
        merged += idx.merge_from(Index.load(path, device=args.device))
    if merged:
        _refit_views(idx, params)
    idx.save(args.out)
    print(json.dumps({"indexes": len(args.indexes), "merged": merged,
                      "rows": idx.num_valid, "out": args.out,
                      "views_refit": [nm for nm, on in params.items()
                                      if on is not None]}))
    return 0


def cmd_query(args) -> int:
    from .data import frontend
    from .index import Index
    idx = Index.load(args.index, device=args.device)
    if idx.extractor is None:
        # a seeded extractor would give descriptors unrelated to the store
        return _error("index has no extractor weights; rebuild it with "
                      "this version or attach an Extractor programmatically")
    img = frontend.load_square(args.image, idx.cfg.extract.image_size)
    if img is None:
        return _error(f"cannot decode {args.image}")
    scfg = idx.cfg.search.replace(k=args.k)
    if args.nprobe is not None:         # 0 = exact even with an IVF view
        scfg = scfg.replace(ivf_nprobe=args.nprobe)
    if args.pq_depth is not None:       # 0 = exact likewise
        scfg = scfg.replace(pq_depth=args.pq_depth)
    if args.ivfpq_nprobe is not None:   # 0 = exact
        scfg = scfg.replace(ivfpq_nprobe=args.ivfpq_nprobe)
    if args.diffusion:
        scfg = scfg.replace(diffusion_enabled=True, rerank_enabled=False,
                            refine_enabled=False, lw_enabled=False)
    if args.lw is not None:
        scfg = scfg.replace(lw_enabled=bool(args.lw))
    if args.spatial_weight is not None:
        scfg = scfg.replace(spatial_weight=args.spatial_weight)
    subset = (idx.make_subset(names=_members(args.subset))
              if args.subset else None)
    scores, ids = idx.query_images(img[None], scfg, subset=subset)
    # padded slots (id -1, score -inf) dropped: -inf is not JSON
    results = [{"rank": r, "name": idx.name_of(i), "id": int(i),
                "score": float(s)}
               for r, (s, i) in enumerate(zip(scores[0], ids[0])) if i >= 0]
    print(json.dumps({"query": args.image, "results": results}))
    return 0


def cmd_info(args) -> int:
    """A saved index's ``Index.stats()`` as one JSON object."""
    from .index import Index
    print(json.dumps(Index.load(args.index, device=args.device).stats()))
    return 0


def cmd_dedupe(args) -> int:
    """Near-duplicate sweep over a saved index (``Index.find_duplicates``):
    the score-sorted pairs and the transitive groups as one JSON object,
    from the stored descriptors alone."""
    from .index import Index
    idx = Index.load(args.index, device=args.device)
    subset = (idx.make_subset(names=_members(args.subset))
              if args.subset else None)
    pairs, scores = idx.find_duplicates(tau=args.tau, k=args.k,
                                        subset=subset)
    groups = idx.find_duplicates(tau=args.tau, k=args.k, subset=subset,
                                 group=True)
    print(json.dumps({
        "tau": args.tau, "n_pairs": len(pairs), "n_groups": len(groups),
        "pairs": [{"a": idx.name_of(a), "b": idx.name_of(b),
                   "score": float(s)}
                  for (a, b), s in zip(pairs.tolist(), scores)],
        "groups": groups,
    }))
    return 0


def cmd_serve(args) -> int:
    """The JSON-lines serving loop (``serve.py``): one request per stdin
    line, one response line on stdout, after a ``{"ready": true, ...}``
    line; with ``--port N`` the same protocol over TCP (N = 0 binds an
    ephemeral port, given in the ready line), concurrent clients' queries
    within ``--batch-wait-ms`` of each other micro-batched into one device
    pass (responses carry ``batch_rows``). ``--host-store DIR
    --ivfpq-view DIR`` serves raw vectors (``VectorServeCore``) instead of
    images; ``--adc-only`` ranks from the pruned scan alone."""
    from .serve import ServeCore, serve_tcp
    if args.host_store:
        from .search.ivfpq import HostRowStore, IVFPQView
        from .serve import VectorServeCore
        if not args.ivfpq_view:
            return _error("--host-store needs --ivfpq-view (a saved "
                          "IVFPQView directory; build with "
                          "IVFPQView.from_host_store(...).save(...))")
        if args.sharded:
            return _error("--host-store serving is single-process (shard by "
                          "running one server per store slice)")
        core = VectorServeCore(HostRowStore(args.host_store),
                               IVFPQView.load(args.ivfpq_view,
                                              device=args.device),
                               adc_only=args.adc_only, device=args.device)
    elif not args.index:
        return _error("serve needs --index (image queries) or --host-store "
                      "+ --ivfpq-view (vector queries)")
    else:
        from .index import Index
        from .parallel import device_mesh
        idx = Index.load(args.index, device=args.device)
        if idx.extractor is None:
            return _error("index has no extractor weights; refusing to "
                          "serve with a random-init extractor (wrong "
                          "retrieval)")
        mesh = (device_mesh(idx.cfg.index.num_shards, idx.device)
                if args.sharded else None)
        core = ServeCore(idx, sharded=args.sharded, mesh=mesh)

    if args.port is not None:              # TCP transport
        def ready_cb(port):
            ready = core.ready_info()
            ready["port"] = port
            print(json.dumps(ready), flush=True)

        return serve_tcp(core, host=args.host, port=args.port,
                         batch_wait_ms=args.batch_wait_ms, ready_cb=ready_cb)

    core.warmup()
    print(json.dumps(core.ready_info()), flush=True)
    for line in sys.stdin:
        line = line.strip()
        if line:
            print(json.dumps(core.handle_line(line)), flush=True)
    return 0


def load_backbone_variables(path: str, backbone: str) -> dict:
    """Extractor weights for ``evaluate --weights``: a torch(vision)
    ``state_dict`` checkpoint (``.pth``/``.pt``) imported onto the port's
    modules (``models/torch_import.py``), or the port's ``finetune``
    checkpoint directory (``utils/checkpoint.py``). Raises
    ``NotImplementedError`` for anything else, the reference's orbax
    trees, naming ``tools/orbax_to_port.py``, which converts them."""
    if not path.endswith((".pth", ".pt")):
        from .utils.checkpoint import load_pytree
        return load_pytree(path)
    import torch

    from .models import torch_import
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    if backbone.startswith("resnet"):
        return torch_import.load_torch_resnet(sd)
    if backbone.startswith("vgg"):
        return torch_import.load_torch_vgg(sd)
    if backbone.startswith("vit"):
        return torch_import.load_torch_vit(sd)
    raise ValueError(f"no torch importer for backbone {backbone!r}")


def cmd_evaluate(args) -> int:
    from .eval.anchors import compare, lookup_anchor
    from .eval.datasets import load_dataset, with_distractors
    from .eval.evaluate import build_index_for_dataset, evaluate_index
    from .parallel import device_mesh
    cfg = _load_cfg(args)
    # flags override the preset's eval block; unset flags fall back to it,
    # so `evaluate --config configs/X.json` alone reproduces the workload
    if args.config:
        dataset = args.dataset or cfg.eval.dataset
        data_root = args.data_root or cfg.eval.data_root
        protocol = args.protocol or cfg.eval.protocol
    else:   # no preset: the bare-invocation defaults
        dataset = args.dataset or "mini"
        data_root = args.data_root or "data"
        protocol = args.protocol or "medium"
    variables = None
    if args.weights:
        try:
            variables = load_backbone_variables(args.weights,
                                                cfg.extract.backbone)
        except NotImplementedError as e:
            return _error(str(e))
    ds = load_dataset(dataset, data_root)
    if args.distractors:
        ds = with_distractors(ds, args.distractors)
    idx = build_index_for_dataset(ds, cfg, variables=variables,
                                  device=args.device)
    sidx = (idx.to_sharded(mesh=device_mesh(cfg.index.num_shards,
                                            idx.device))
            if args.sharded else None)
    res = evaluate_index(idx, ds, protocol, sharded_index=sidx)
    res.pop("per_query_ap", None)
    if args.sharded:
        res["sharded"] = True
        res["num_shards"] = sidx.mesh.num_shards
    # measured-vs-anchor report whenever a literature anchor matches this
    # config, dataset and protocol
    anchor = lookup_anchor(cfg, dataset, protocol)
    if anchor is not None and "mAP" in res:
        res["anchor"] = compare(res["mAP"], anchor)
    print(json.dumps(res))
    return 0


def cmd_bench(args) -> int:
    return _error("bench runs the JAX package's benchmark harness, which is "
                  "not ported; the port's benchmark is ROADMAP M10a")


def cmd_finetune(args) -> int:
    """Fine-tune a backbone on a labelled image tree: each subdirectory of
    --images is one instance or class (arXiv:1711.02512)."""
    import numpy as np

    from .config import TrainConfig
    from .train.finetune import finetune
    from .utils.checkpoint import save_pytree

    if not os.path.isdir(args.images):
        return _error(f"{args.images} is not a directory")
    paths, labels = [], []
    for li, sub in enumerate(sorted(os.listdir(args.images))):
        d = os.path.join(args.images, sub)
        if not os.path.isdir(d):
            continue
        for p in _image_paths(d):
            paths.append(p)
            labels.append(li)
    n_classes = len(set(labels))
    if not paths or n_classes < 2:
        return _error(f"need >= 2 class subdirectories with images under "
                      f"{args.images} (found {n_classes})")
    counts = np.bincount(np.asarray(labels))
    num_neg = min(args.num_negatives, int(counts.sum() - counts.max()))
    cfg = TrainConfig(backbone=args.backbone or "resnet50",
                      image_size=args.image_size, learn_gem_p=args.learn_p,
                      batch_size=args.batch_size,
                      num_negatives=max(1, num_neg), lr=args.lr,
                      loss=args.loss, smoothap_tau=args.smoothap_tau)
    init_vars = None
    if args.eval_dataset:
        # the frozen weights the run starts from, for the tuned-versus-
        # frozen report (the trainer copies them, so they stay frozen)
        from .train.trainer import Trainer
        init_vars = Trainer(cfg, seed=0, device=args.device).variables
    try:
        out = finetune(paths, np.asarray(labels), cfg, epochs=args.epochs,
                       fit_lw=args.fit_lw, variables=init_vars,
                       device=args.device)
    except ValueError as e:
        return _error(str(e))
    save_pytree(args.out, out["variables"])
    # the learned GeM exponent is not a backbone variable: the sidecar
    # carries it, and the rest of the tuned model's description
    meta = {"gem_p": out["gem_p"], "backbone": cfg.backbone,
            "pooling": cfg.pooling, "image_size": cfg.image_size}
    if "whitening" in out:
        w = out["whitening"]
        np.savez(args.out + ".whitening.npz", P=w.P.cpu().numpy(),
                 mu=w.mu.cpu().numpy())
        meta["whitening"] = os.path.abspath(args.out + ".whitening.npz")
    with open(args.out + ".meta.json", "w") as fh:
        json.dump(meta, fh)
    report = {"steps": len(out["losses"]),
              "final_loss": out["losses"][-1],
              "gem_p": out["gem_p"], "out": args.out,
              "meta": args.out + ".meta.json"}
    if args.eval_dataset:
        # the tuned-versus-frozen retrieval lift on a held-out dataset
        from .config import ExtractConfig
        from .eval.datasets import load_dataset
        from .eval.evaluate import build_index_for_dataset, evaluate_index
        ds = load_dataset(args.eval_dataset, args.eval_data_root)

        def _map(variables, gem_p):
            pcfg = PipelineConfig(extract=ExtractConfig(
                backbone=cfg.backbone, pooling=cfg.pooling, gem_p=gem_p,
                image_size=cfg.image_size, batch_size=cfg.batch_size * 4,
                dtype="float32"))
            idx = build_index_for_dataset(ds, pcfg, variables=variables,
                                          device=args.device)
            return evaluate_index(idx, ds, args.eval_protocol)["mAP"]

        frozen = _map(init_vars, cfg.gem_p)
        tuned = _map(out["variables"], out["gem_p"])
        report.update(eval_dataset=args.eval_dataset,
                      eval_protocol=args.eval_protocol,
                      frozen_mAP=round(frozen, 2), tuned_mAP=round(tuned, 2),
                      lift=round(tuned - frozen, 2))
    print(json.dumps(report))
    return 0


def cmd_workloads(args) -> int:
    from .workloads import run_all
    for res in run_all(args.data_root, args.dataset, device=args.device):
        print(json.dumps(res))
    return 0


def main(argv=None) -> int:
    device_help = ("where the work runs: a torch device such as cpu or "
                   "cuda:1 (default: the CUDA card; refused without one)")
    p = argparse.ArgumentParser(prog="instsearch")
    p.add_argument("--device", default=None, help=device_help)
    # the same option after the subcommand; SUPPRESS keeps a subcommand
    # that is not given it from resetting the one given before
    on_sub = argparse.ArgumentParser(add_help=False)
    on_sub.add_argument("--device", default=argparse.SUPPRESS,
                        help=device_help)
    sub = p.add_subparsers(dest="cmd", required=True)

    b = sub.add_parser("build-index", parents=[on_sub],
                       help="extract + index a directory of images")
    b.add_argument("--images", required=True)
    b.add_argument("--out", required=True)
    b.add_argument("--config", default=None)
    b.add_argument("--backbone", default=None)
    b.add_argument("--resumable", action="store_true",
                   help="flush per batch-group with a manifest; restart "
                        "resumes")
    b.add_argument("--weights", default=None,
                   help="a `finetune` checkpoint (reads the .meta.json "
                        "sidecar for gem_p/backbone and the Lw whitening)")
    b.add_argument("--dba-n", type=int, default=0,
                   help="database-side augmentation: aggregate each row's "
                        "top-n neighbors offline (0 = off)")
    b.add_argument("--dba-alpha", type=float, default=3.0,
                   help="αDBA similarity weighting exponent")
    b.add_argument("--ivf", action="store_true",
                   help="attach an IVF ANN view (k-means coarse quantizer; "
                        "query/serve then scan ~nprobe/clusters of the rows)")
    b.add_argument("--ivf-clusters", type=int, default=0,
                   help="IVF cluster count (default: ~sqrt(N))")
    b.add_argument("--nprobe", type=int, default=32,
                   help="IVF probes per query (with --ivf)")
    b.add_argument("--lw", action="store_true",
                   help="fit a local-whitening re-ranking view (per-"
                        "cluster metric re-scoring of the top candidates; "
                        "enables lw_enabled in the saved SearchConfig)")
    b.add_argument("--lw-clusters", type=int, default=0,
                   help="local-whitening expert count (default: ~sqrt(N))")
    b.add_argument("--pq", action="store_true",
                   help="attach a product-quantization cascade view (4-bit "
                        "ADC coarse scan + exact re-score of the top "
                        "candidates; search/pq_view.py)")
    b.add_argument("--pq-m", type=int, default=0,
                   help="PQ subquantizer count (default: D/8)")
    b.add_argument("--pq-depth", type=int, default=100,
                   help="PQ cascade candidate depth (with --pq)")
    b.add_argument("--opq-iters", type=int, default=0,
                   help="OPQ rotation alternations for --pq / --ivfpq "
                        "(0 = plain PQ; ~8 typical — better candidate "
                        "recall at the same 32 B/row; for --ivfpq the "
                        "rotation is learned in residual space)")
    b.add_argument("--apq-t", type=float, default=0.0,
                   help="anisotropic (score-aware, ScaNN) threshold for "
                        "--pq / --ivfpq codebooks (0 = plain MSE fit; "
                        "~0.2 typical — raw-ADC ranking quality for "
                        "ADC-only serving; mutually exclusive with "
                        "--opq-iters)")
    b.add_argument("--ivfpq", action="store_true",
                   help="attach an IVF-PQ cascade view (k-means-bucketed "
                        "4-bit residual codes: the PQ store's 32 B/row "
                        "with the ADC scan pruned to ~nprobe/clusters; "
                        "search/ivfpq.py). Mutually exclusive with "
                        "--ivf/--pq; uses --ivf-clusters/--nprobe/--pq-m/"
                        "--pq-depth for its sizing")
    b.set_defaults(fn=cmd_build_index)

    u = sub.add_parser("update-index", parents=[on_sub],
                       help="add/remove images on a saved index (offline "
                            "counterpart of serve's add/remove requests)")
    u.add_argument("--index", required=True, help="saved index directory")
    u.add_argument("--add", nargs="*", default=[],
                   help="image files or directories to index")
    u.add_argument("--remove", nargs="*", default=[],
                   help="image names (no extension) to remove")
    u.add_argument("--out", default=None,
                   help="write the updated index here (default: in place)")
    u.set_defaults(fn=cmd_update_index)

    mg = sub.add_parser("merge-index", parents=[on_sub],
                        help="combine independently-built indexes into one "
                             "(same extraction pipeline, disjoint names; "
                             "FAISS merge_from analog)")
    mg.add_argument("indexes", nargs="+",
                    help="saved index directories; the first one's "
                         "storage dtype/capacity rules apply")
    mg.add_argument("--out", required=True,
                    help="write the merged index here")
    mg.set_defaults(fn=cmd_merge_index)

    q = sub.add_parser("query", parents=[on_sub],
                       help="query an index with an image")
    q.add_argument("--index", required=True)
    q.add_argument("--image", required=True)
    q.add_argument("-k", type=int, default=10)
    q.add_argument("--nprobe", type=int, default=None,
                   help="IVF probes (indexes built with --ivf; 0 = exact)")
    q.add_argument("--pq-depth", type=int, default=None,
                   help="PQ cascade depth (indexes built with --pq; "
                        "0 = exact)")
    q.add_argument("--ivfpq-nprobe", type=int, default=None,
                   help="IVF-PQ probes (indexes built with --ivfpq; "
                        "0 = exact)")
    q.add_argument("--diffusion", action="store_true",
                   help="diffusion re-ranking over the top candidates' "
                        "similarity graph (search/diffusion.py; depth etc. "
                        "from the index's SearchConfig)")
    q.add_argument("--lw", type=int, choices=(0, 1), default=None,
                   help="force local-whitening re-scoring on (1) or off "
                        "(0); default: the index's SearchConfig")
    q.add_argument("--subset", default=None, metavar="NAMES|@FILE",
                   help="restrict results to these image names "
                        "(comma-separated, or @file with one name per "
                        "line) — filtered search, search/subset.py")
    q.add_argument("--spatial-weight", type=float, default=None,
                   help="fuse Hough-vote spatial verification into the "
                        "regional re-rank at this weight (needs a "
                        "rerank-enabled index built by this version)")
    q.set_defaults(fn=cmd_query)

    nf = sub.add_parser("info", parents=[on_sub],
                        help="print a saved index's stats (rows, dtype, "
                             "bytes, attached views) as JSON")
    nf.add_argument("--index", required=True)
    nf.set_defaults(fn=cmd_info)

    dd = sub.add_parser("dedupe", parents=[on_sub],
                        help="near-duplicate sweep over an index (pairs >= "
                             "tau + transitive groups; "
                             "Index.find_duplicates)")
    dd.add_argument("--index", required=True)
    dd.add_argument("--tau", type=float, default=0.97,
                    help="cosine threshold for a duplicate pair")
    dd.add_argument("-k", type=int, default=16,
                    help="kNN-graph degree: max pairs contributed per "
                         "image (groups are transitive regardless)")
    dd.add_argument("--subset", default=None, metavar="NAMES|@FILE",
                    help="restrict the neighbor side to these image names")
    dd.set_defaults(fn=cmd_dedupe)

    e = sub.add_parser("evaluate", parents=[on_sub],
                       help="protocol evaluation on a dataset")
    # None defaults fall back to the preset's eval block (see cmd_evaluate)
    e.add_argument("--dataset", default=None)
    e.add_argument("--data-root", default=None)
    e.add_argument("--protocol", default=None,
                   choices=["easy", "medium", "hard", "classic"])
    e.add_argument("--config", default=None)
    e.add_argument("--backbone", default=None)
    e.add_argument("--weights", default=None,
                   help="extractor weights: a torchvision .pth state_dict "
                        "(converted on load) or the port's `finetune` "
                        "checkpoint; an orbax tree from the JAX package is "
                        "converted first by tools/orbax_to_port.py")
    e.add_argument("--distractors", default=None,
                   help="directory of distractor images (Oxford105k-style)")
    e.add_argument("--sharded", action="store_true",
                   help="rank through the row-sharded index "
                        "(cfg.index.num_shards shards over the cards)")
    e.set_defaults(fn=cmd_evaluate)

    sv = sub.add_parser("serve", parents=[on_sub],
                        help="JSON-lines serving loop over a saved index "
                             "(one request per stdin line)")
    sv.add_argument("--index", default=None,
                    help="saved index directory (image-query serving); "
                         "omit when serving a --host-store")
    sv.add_argument("--host-store", default=None, metavar="DIR",
                    help="capacity-scale VECTOR serving: a HostRowStore "
                         "directory (exact rows in a host memmap, codes "
                         "on the card); requests carry {\"vector\": [...]} "
                         "instead of image paths; needs --ivfpq-view")
    sv.add_argument("--ivfpq-view", default=None, metavar="DIR",
                    help="saved IVFPQView directory for --host-store "
                         "(IVFPQView.from_host_store(...).save(...))")
    sv.add_argument("--adc-only", action="store_true",
                    help="with --host-store: rank straight from the "
                         "pruned ADC scan, no host gather / re-score "
                         "(latency mode; fit the view with "
                         "--apq-t-style anisotropic codes for raw-ADC "
                         "quality)")
    sv.add_argument("--sharded", action="store_true",
                    help="serve through the row-sharded index over the "
                         "cards")
    sv.add_argument("--port", type=int, default=None,
                    help="serve over TCP on this port instead of stdin "
                         "(0 = ephemeral, printed in the ready line); "
                         "concurrent clients' requests are micro-batched "
                         "into one device pass")
    sv.add_argument("--host", default="127.0.0.1")
    sv.add_argument("--batch-wait-ms", type=float, default=2.0,
                    help="how long the dispatcher holds a TCP query batch "
                         "open for stragglers from other connections")
    sv.set_defaults(fn=cmd_serve)

    be = sub.add_parser("bench", parents=[on_sub],
                        help="run benchmark harness (not ported: ROADMAP "
                             "M10a)")
    be.add_argument("--what", default="all",
                    choices=["extraction", "query", "all", "extended"])
    be.add_argument("--trace", default=None, metavar="DIR",
                    help="write a TensorBoard profiler trace to DIR")
    be.add_argument("--tensorboard", default=None, metavar="DIR",
                    help="emit counters + bench scalars via tensorboardX")
    be.set_defaults(fn=cmd_bench)

    f = sub.add_parser("finetune", parents=[on_sub],
                       help="contrastive fine-tuning on a labeled image tree")
    f.add_argument("--images", required=True,
                   help="directory with one subdirectory per instance/class")
    f.add_argument("--out", required=True,
                   help="checkpoint directory (torch_weights.pt)")
    f.add_argument("--backbone", default=None)
    f.add_argument("--image-size", type=int, default=224)
    f.add_argument("--epochs", type=int, default=1)
    f.add_argument("--learn-p", action="store_true")
    f.add_argument("--batch-size", type=int, default=8)
    f.add_argument("--num-negatives", type=int, default=5)
    f.add_argument("--lr", type=float, default=1e-4)
    f.add_argument("--loss", default="contrastive",
                   choices=["contrastive", "triplet", "smoothap"],
                   help="smoothap = listwise sigmoid-relaxed AP "
                        "(arXiv:2007.12163)")
    f.add_argument("--smoothap-tau", type=float, default=0.01)
    f.add_argument("--fit-lw", action="store_true",
                   help="fit Lw discriminative whitening on the training "
                        "pairs after tuning (arXiv:1711.02512 §3.4)")
    f.add_argument("--eval-dataset", default=None,
                   help="held-out dataset name: report tuned-vs-frozen mAP "
                        "lift after training (same loader as `evaluate`)")
    f.add_argument("--eval-data-root", default="data")
    f.add_argument("--eval-protocol", default="medium",
                   choices=["classic", "easy", "medium", "hard"])
    f.set_defaults(fn=cmd_finetune)

    w = sub.add_parser("workloads", parents=[on_sub],
                       help="run all workload presets end-to-end")
    w.add_argument("--data-root", default="data")
    w.add_argument("--dataset", default="mini")
    w.set_defaults(fn=cmd_workloads)

    args = p.parse_args(argv)
    if args.fn is not cmd_bench:
        try:
            args.device = resolve_device(args.device)
        except RuntimeError as e:
            return _error(str(e))
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
