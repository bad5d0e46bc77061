"""End-to-end walkthrough on the PyTorch port — the same steps, arguments
and printed lines as ``examples/end_to_end.py``, through
``instsearch_torch``.

Runs on the synthetic mini dataset out of the box (no downloads needed);
point ``--data-root``/``--dataset`` at a real Oxford/Paris layout
(eval/datasets.py documents both on-disk formats) for the full protocol.
The backbone's weights are seeded, as the reference's are without a
checkpoint. On the card the int8 store's searches, αQE, diffusion's kNN
graph and αDBA run the fused int8 top-k kernel (K2,
``kernels/topk_matmul.py``).

    python examples/torch_end_to_end.py                 # mini, the card
    python examples/torch_end_to_end.py --device cpu
    python examples/torch_end_to_end.py --dataset roxford5k --data-root /data
"""
import argparse
import os


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="mini")
    ap.add_argument("--data-root", default="data")
    ap.add_argument("--backbone", default="vgg16")
    ap.add_argument("--image-size", type=int, default=64)
    ap.add_argument("--workdir", default=".",
                    help="where step 5 saves the index (example_index)")
    ap.add_argument("--device", default=None,
                    help="where the work runs: a torch device such as cpu "
                         "or cuda:0 (default: the CUDA card; raises without "
                         "one)")
    args = ap.parse_args(argv)

    from instsearch_torch import (
        ExtractConfig, IndexConfig, PipelineConfig, SearchConfig,
    )
    from instsearch_torch.data import frontend
    from instsearch_torch.eval import load_dataset
    from instsearch_torch.index import Index
    from instsearch_torch.parallel import device_mesh
    from instsearch_torch.utils.device import resolve_device

    device = resolve_device(args.device)

    # ---- 1. dataset -------------------------------------------------------
    ds = load_dataset(args.dataset, args.data_root)
    print(f"dataset {ds.name}: {len(ds.imlist)} db images, "
          f"{len(ds.qimlist)} queries")

    # ---- 2. build: extract -> whiten -> store (int8, rerank-ready) -------
    cfg = PipelineConfig(
        extract=ExtractConfig(backbone=args.backbone, pooling="rmac",
                              image_size=args.image_size, batch_size=8,
                              whiten=True),
        index=IndexConfig(dtype="int8", row_tile=8),
        search=SearchConfig(k=5, rerank_enabled=True, rerank_depth=16))
    index = Index.build(ds.db_paths, cfg, device=device)
    print(f"indexed {index.num_valid} images, dim {index.dim}, "
          f"storage {index.descriptors.dtype}")

    # ---- 3. query one image (global + regional re-rank) ------------------
    img = frontend.load_square(ds.db_paths[0], args.image_size)
    scores, ids = index.query(img, k=5)
    print("query results:", [(index.name_of(int(i)), round(float(s), 4))
                             for s, i in zip(scores[0], ids[0]) if i >= 0])

    # filtered search (search/subset.py): restrict any query to a named
    # collection — a reusable device-resident mask applied in the scan
    collection = index.make_subset(names=index.names[::2])
    s_f, i_f = index.query(img, k=5, subset=collection)
    print("filtered results:", [(index.name_of(int(i)), round(float(s), 4))
                                for s, i in zip(s_f[0], i_f[0]) if i >= 0])

    # ---- 4. protocol evaluation: the quality ladder ------------------------
    for scfg, tag in ((SearchConfig(), "base"),
                      (SearchConfig(qe_enabled=True, qe_n=5), "alpha-QE"),
                      (SearchConfig(rerank_enabled=True, rerank_depth=16),
                       "regional re-rank"),
                      (SearchConfig(diffusion_enabled=True,
                                    diffusion_depth=16, diffusion_knn=4),
                       "diffusion")):
        res = index.evaluate(ds, "medium", scfg)
        print(f"{tag:18s} mAP {res['mAP']:6.2f}  "
              f"mP@5 {res.get('mP@5', 0):6.2f}")

    # spatial verification fuses into the re-rank: region-pair Hough
    # voting separates scrambled-layout near-duplicates the arrangement-
    # invariant region match cannot (search/spatial.py)
    res = index.evaluate(ds, "medium", SearchConfig(
        rerank_enabled=True, rerank_depth=16, spatial_weight=0.5))
    print(f"{'re-rank + spatial':18s} mAP {res['mAP']:6.2f}")

    # local-whitening re-ranking: per-cluster metric re-scoring (fit is a
    # one-off, like the IVF view; mutually exclusive with the re-rank)
    index.fit_local_whitening(n_clusters=4)
    res = index.evaluate(ds, "medium", SearchConfig(
        lw_enabled=True, rerank_depth=16))
    print(f"{'local whitening':18s} mAP {res['mAP']:6.2f}")

    # optional offline quality: alpha-DBA augments the STORED rows once
    # (zero query-time cost; mesh=... routes it through the sharded scan)
    index.augment_database(n=5)   # NB: invalidates the lw view (refit if
    res = index.evaluate(ds, "medium", SearchConfig())  # you keep using it)
    print(f"{'alpha-DBA (offline)':18s} mAP {res['mAP']:6.2f}")

    # ---- 5. persist (npz or the port's stream, by size; + the weights) ----
    path = os.path.join(args.workdir, "example_index")
    index.save(path)
    reloaded = Index.load(path, device=device)  # weights + whitening restored
    print("reloaded:", reloaded.num_valid, "rows,",
          "weights" if reloaded.extractor is not None else "no weights")

    # ---- 6. distributed serving + sharded protocol evaluation -------------
    # default policy: config pins the shard count, else every device
    mesh = device_mesh(index.cfg.index.num_shards, index.device)
    sharded = index.to_sharded(mesh=mesh)
    q = index.descriptors[:1, :index.dim].float().cpu().numpy()
    if index.scales is not None:
        q = q * index.scales[0, :1, None].cpu().numpy()
    s, i = sharded.search(q, k=3)
    print("sharded search over", sharded.mesh.num_shards, "device(s):",
          i[0].tolist())
    if device_mesh(0, index.device).num_shards > 1:
        res = index.evaluate(ds, "medium", sharded=True, mesh=mesh)
        print(f"sharded evaluation  mAP {res['mAP']:6.2f} "
              f"(ranked through ShardedIndex)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
