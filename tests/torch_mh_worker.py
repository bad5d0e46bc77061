"""Worker of the port's multi-process test (test_torch_multihost.py): one of
P processes, each holding 4 CPU shards of a ShardedIndex whose rows span the
processes, joined by gloo over the loopback.

    python torch_mh_worker.py <rank> <world> <port> <out_dir>

Each process makes the same seeded stores (a bf16 and an int8 Index with
regional stores), hands ``build_multihost_index`` only its own rows, row
scales and regional rows, with the route left at its default (the
kernels), runs search, search_qe, full_ranking and search_rerank, and
writes the answers to ``<out_dir>/rank<rank>.npz``. It imports no JAX.
"""
import os
import sys

import numpy as np

N, D, R, K, QE_N, DEPTH, LOCAL_SHARDS = 250, 32, 6, 5, 4, 24, 4


def make_data():
    """The rows, queries, regional rows and query regions every process and
    the test make alike."""
    rng = np.random.default_rng(17)
    x = rng.standard_normal((N, D)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = x[:7] + 0.02 * rng.standard_normal((7, D)).astype(np.float32)
    reg = rng.standard_normal((N, R, D)).astype(np.float32)
    reg /= np.linalg.norm(reg, axis=-1, keepdims=True)
    qreg = reg[:7] + 0.05 * rng.standard_normal((7, R, D)).astype(np.float32)
    return x, q, reg, qreg


def make_index(dtype: str):
    """The single-process Index over all rows, with its regional store: 8
    shards' padding (row tile 8), so 256 rows, the last shard ending in
    padding."""
    from instsearch_torch import IndexConfig, PipelineConfig, SearchConfig
    from instsearch_torch.index import Index, attach_regional_store
    x, _, reg, _ = make_data()
    cfg = PipelineConfig(index=IndexConfig(dtype=dtype, row_tile=8,
                                           num_shards=8),
                         search=SearchConfig(k=K))
    idx = Index.from_descriptors(x, [f"r{i}" for i in range(N)], cfg,
                                 device="cpu")
    attach_regional_store(idx, reg)
    return idx


def main(rank: int, world: int, port: str, out: str) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=port)
    import torch.distributed as dist
    from instsearch_torch.parallel import (build_multihost_index,
                                           global_shard_mesh, initialize,
                                           local_row_range)
    assert initialize(backend="gloo")
    assert dist.get_world_size() == world and dist.get_rank() == rank
    mesh = global_shard_mesh(["cpu"] * LOCAL_SHARDS)
    assert mesh.num_shards == world * LOCAL_SHARDS
    _, q, _, qreg = make_data()
    res = {}
    for dtype in ("bfloat16", "int8"):
        idx = make_index(dtype)
        lo, hi = local_row_range(idx.descriptors.shape[0])
        sidx = build_multihost_index(
            idx.descriptors[lo:hi].clone(), idx.ids.numpy(), mesh=mesh,
            local_scales=(None if idx.scales is None
                          else idx.scales[:, lo:hi].clone()),
            local_regional=idx.regional[lo:hi].clone(),
            local_regional_scales=(None if idx.regional_scales is None
                                   else idx.regional_scales[lo:hi].clone()),
            k=K)
        assert sidx.descriptors.shape[0] == hi - lo
        for name, (s, i) in (
                ("search", sidx.search(q)),
                ("qe", sidx.search_qe(q, qe_n=QE_N)),
                ("rerank", sidx.search_rerank(q, qreg, depth=DEPTH))):
            res[f"{dtype}_{name}_s"] = s.numpy()
            res[f"{dtype}_{name}_i"] = i.numpy()
        res[f"{dtype}_ranking"] = sidx.full_ranking(q)
    assert "jax" not in sys.modules
    np.savez(os.path.join(out, f"rank{rank}.npz"), **res)
    dist.destroy_process_group()
    print(f"MH_OK {rank}", flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
