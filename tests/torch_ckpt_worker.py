"""Worker of the port's two-process sharded-checkpoint test
(test_torch_sharded_checkpoint.py): one of P processes, each holding 2 CPU
shards of a mesh whose rows span the processes, joined by gloo over the
loopback.

    python torch_ckpt_worker.py <rank> <world> <port> <out_dir>

Each process makes the same seeded tree and index. It writes its own rows
of the tree with ``save_sharded_pytree`` into ``<out_dir>/tree`` and reads
them back placed with ``load_sharded_pytree``; then it loads the index
(an npz rank 0 wrote) placed on the mesh, saves it as the port's stream
into ``<out_dir>/stream`` and loads that back placed. Its local parts and
search answers go to ``<out_dir>/rank<rank>.npz``. It imports no JAX.
"""
import os
import sys

import numpy as np

ROWS, COLS, N, CAPACITY, D, R, LOCAL_SHARDS = 32, 12, 50, 64, 24, 3, 2


def make_tree():
    """The seeded tree every process and the test make alike: bf16 rows, f32
    row scales ``[1, ROWS]`` and a whole f32 leaf."""
    import torch
    g = torch.Generator().manual_seed(5)
    return (torch.randn(ROWS, COLS, generator=g).to(torch.bfloat16),
            torch.rand(1, ROWS, generator=g),
            torch.randn(COLS, generator=g))


def make_index():
    """An int8 Index over seeded rows with an int8 regional store, padded
    to CAPACITY rows (4 shards of 16, the last ones padding)."""
    from instsearch_torch import IndexConfig, PipelineConfig, SearchConfig
    from instsearch_torch.index import Index, attach_regional_store
    rng = np.random.default_rng(9)
    x = rng.standard_normal((N, D)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    reg = rng.standard_normal((N, R, D)).astype(np.float32)
    cfg = PipelineConfig(index=IndexConfig(dtype="int8", row_tile=8,
                                           capacity=CAPACITY),
                         search=SearchConfig(k=5))
    idx = Index.from_descriptors(x, [f"r{i}" for i in range(N)], cfg,
                                 device="cpu")
    attach_regional_store(idx, reg)
    return idx, x[[1, 20, 41]]


def main(rank: int, world: int, port: str, out: str) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=port)
    import torch
    import torch.distributed as dist
    from instsearch_torch.index import Index
    from instsearch_torch.parallel import (global_shard_mesh, initialize,
                                           local_row_range, shard_rows)
    from instsearch_torch.utils.checkpoint import (Placed,
                                                   load_sharded_pytree,
                                                   save_sharded_pytree)
    assert initialize(backend="gloo")
    mesh = global_shard_mesh(["cpu"] * LOCAL_SHARDS)
    assert mesh.num_shards == world * LOCAL_SHARDS
    res = {}

    x, s, w = make_tree()
    lo, hi = local_row_range(ROWS)
    tree = os.path.join(out, "tree")
    save_sharded_pytree(tree, {
        "x": Placed(shard_rows(mesh, x[lo:hi]), 0, mesh),
        "s": Placed(shard_rows(mesh, s[:, lo:hi], dim=1), 1, mesh),
        "w": w})
    back = load_sharded_pytree(tree, {"x": (mesh, 0), "s": (mesh, 1)})
    assert torch.equal(back["w"], w)
    for j, (bx, bs) in enumerate(zip(back["x"], back["s"])):
        assert bx.dtype == torch.bfloat16
        res[f"tree_x{j}"] = bx.float().numpy()
        res[f"tree_s{j}"] = bs.numpy()

    idx, q = make_index()
    npz = os.path.join(out, "npz")
    if rank == 0:
        idx.save(npz, streaming=False)
    dist.barrier()
    placed = Index.load(npz, mesh=mesh)
    stream = os.path.join(out, "stream")
    placed.save(stream, streaming=True)
    again = Index.load(stream, mesh=mesh)
    for j, (a, b) in enumerate(zip(again.placement.shards,
                                   placed.placement.shards)):
        for name in ("x", "scales", "regional", "regional_scales"):
            assert torch.equal(getattr(a, name), getattr(b, name)), name
        res[f"index_x{j}"] = a.x.numpy()
    s_, i_ = again.search(q)
    res["search_s"], res["search_i"] = s_, i_
    assert "jax" not in sys.modules
    np.savez(os.path.join(out, f"rank{rank}.npz"), **res)
    dist.destroy_process_group()
    print(f"CKPT_OK {rank}", flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
