"""Raw-vector index walkthrough on the PyTorch port — the FAISS-migration
surface in one script: build from descriptors, exact + filtered + range
search, the Euclidean metric, offline corpus analytics (kNN graph, dedup,
reconstruct) and operator introspection. The same steps, arguments and
printed lines as ``examples/vector_ops.py``, through ``instsearch_torch``.

No images, no downloads, no extractor — this is the path production
vector workloads use when descriptors come from somewhere else
(docs/MIGRATION.md maps each step to its FAISS counterpart). On the card
the bf16 store's searches, range search and kNN graph run the fused top-k
kernel (K1, ``kernels/topk_matmul.py``).

    python examples/torch_vector_ops.py                # the CUDA card
    python examples/torch_vector_ops.py --device cpu
"""
import argparse
import json
import tempfile

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="where the work runs: a torch device such as cpu "
                         "or cuda:0 (default: the CUDA card; raises without "
                         "one)")
    args = ap.parse_args(argv)

    from instsearch_torch import (
        ExtractConfig, IndexConfig, PipelineConfig, SearchConfig,
    )
    from instsearch_torch.index import Index
    from instsearch_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    rng = np.random.default_rng(0)
    n, d = 4096, 128

    # ---- cosine/IP index over unit vectors (IndexFlatIP analog) ------
    X = rng.standard_normal((n, d)).astype(np.float32)
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    X[100] = X[7]                                  # plant a duplicate
    cfg = PipelineConfig(
        extract=ExtractConfig(dtype="float32"),
        index=IndexConfig(dtype="bfloat16", row_tile=8),
        search=SearchConfig(k=5))
    idx = Index.from_descriptors(X, [f"im{i}" for i in range(n)], cfg,
                                 device=device)

    q = X[:3] + 0.02 * rng.standard_normal((3, d)).astype(np.float32)
    s, i = idx.search(q)
    print("top-1:", i[:, 0].tolist(), "scores:", np.round(s[:, 0], 3).tolist())

    # filtered search (IDSelector analog): reusable named subset
    evens = idx.make_subset(names=[f"im{j}" for j in range(0, n, 2)])
    _, i_f = idx.search(q, subset=evens)
    assert ((i_f < 0) | (i_f % 2 == 0)).all()

    # range search: members above a score threshold + EXACT counts
    s_r, i_r, counts = idx.search_range(q, tau=0.5, max_results=64)
    print("range counts @0.5:", counts.tolist(),
          "(counts > max_results would flag truncation)")

    # offline analytics: kNN graph -> near-duplicate groups
    groups = idx.find_duplicates(tau=0.99, group=True)
    print("duplicate groups:", groups)            # [['im7', 'im100']]

    # stored rows back out (reconstruct analog; bf16 storage precision)
    rec = idx.reconstruct(names=["im7"])
    print("reconstruct cos:", float(rec[0] @ X[7] / np.linalg.norm(rec[0])))

    # operator snapshot + persistence round-trip
    print("stats:", json.dumps({k: v for k, v in idx.stats().items()
                                if k != "bytes"}))
    with tempfile.TemporaryDirectory() as tmp:
        idx.save(tmp + "/idx")
        back = Index.load(tmp + "/idx", device=device)
        assert back.num_valid == n

    # ---- Euclidean metric (IndexFlatL2 analog) -----------------------
    Y = (3.0 * rng.standard_normal((2048, 64))).astype(np.float32)
    l2cfg = PipelineConfig(
        extract=ExtractConfig(dtype="float32"),
        index=IndexConfig(dtype="float32", row_tile=8, metric="l2"),
        search=SearchConfig(k=5))
    l2idx = Index.from_descriptors(
        Y, [f"v{i}" for i in range(2048)], l2cfg, device=device)
    qy = Y[:2] + 0.1
    s2, i2 = l2idx.search(qy)                     # scores are -||x-q||^2
    print("l2 nearest dist:", np.round(np.sqrt(-s2[:, 0]), 4).tolist())
    _, _, c2 = l2idx.search_range(qy, tau=5.0)    # tau = RADIUS here
    print("rows within radius 5.0:", c2.tolist())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
