"""Worker of the two-process placed-mutation test
(test_torch_placed_mutation.py): one of P processes, each holding 2 CPU
shards of a mesh whose rows span the processes, joined by gloo over the
loopback.

    python torch_mutation_worker.py <rank> <world> <port> <out_dir>

For each store kind, rank 0 saves the seeded index and a seeded donor
(npz); every process loads both placed on the mesh and runs
:func:`mutate` (a ``remove`` whose holes lie on rank 0 and survivors on
rank 1, an ``add``, ``merge_from`` the placed donor and an unplaced one),
with ``torch.distributed.all_gather`` wrapped to count the bytes of every
tensor passed to it; then an ``add`` past capacity, which must raise. Then
the candidate tiers: rank 0 saves a seeded store for each view of
``TIER_VIEWS`` with the view fitted; every process loads it placed, runs
:func:`mutate_tier` (the views' absorbs read the rows through the
collective ``ShardedIndex.read_rows``) and :func:`tier_searches` (plain
and with αQE), counting the bytes ``all_gather`` moves during each search;
and every process passes ``read_rows`` other positions than the other
process, which must raise ``RuntimeError`` on both. Its parts (as bytes),
ids, names, views, search answers and counts go to
``<out_dir>/rank<rank>.npz``. It imports no JAX.
"""
import os
import sys

import numpy as np

KINDS = ("bfloat16", "int8")
N, CAPACITY, D, R, LOCAL_SHARDS, DONOR, ADDED = 100, 128, 512, 2, 2, 12, 6
# holes 3, 17, 40 (rank 0's rows 0..63), survivors 96, 97, 98 (rank 1's)
REMOVE = ["r3", "r17", "r40", "r99"]
STORES = ("descriptors", "scales", "regional", "regional_scales")


def _unit(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _index(kind, rows, names, reg, capacity):
    from instsearch_torch import IndexConfig, PipelineConfig, SearchConfig
    from instsearch_torch.index import Index, attach_regional_store
    cfg = PipelineConfig(index=IndexConfig(dtype=kind, row_tile=8,
                                           capacity=capacity),
                         search=SearchConfig(k=5))
    idx = Index.from_descriptors(rows, names, cfg, device="cpu")
    if kind == "int8":
        attach_regional_store(idx, reg)
    return idx


def make_index(kind):
    """The seeded index every process and the test make alike (int8 with an
    int8 regional store), 4 shards of 32 rows."""
    rng = np.random.default_rng(31)
    return _index(kind, _unit(rng, (N, D)), [f"r{i}" for i in range(N)],
                  _unit(rng, (N, R, D)), CAPACITY)


def make_donor(kind, tag):
    """A seeded donor of ``DONOR`` rows named ``<tag><i>``, 4 shards of 8
    rows."""
    rng = np.random.default_rng(ord(tag))
    return _index(kind, _unit(rng, (DONOR, D)),
                  [f"{tag}{i}" for i in range(DONOR)],
                  _unit(rng, (DONOR, R, D)), 32)


def queries(kind):
    return _unit(np.random.default_rng(7), (5, D))


# the candidate tiers: 480 rows in 512 (4 shards of 128, 2 a process) at
# D = 64; each view on the store kind it serves
TIER_VIEWS = {"pq": "int4", "ivfpq": "int4", "ivf": "int8"}
TIER_N, TIER_CAPACITY, TIER_D = 480, 512, 64
TIER_B, TIER_K, TIER_DEPTH, TIER_QE, TIER_ADDED = 3, 5, 16, 4, 6
# holes on rank 0's rows (0..255) and on rank 1's; survivors on rank 1's
TIER_REMOVE = ["t3", "t70", "t200", "t470"]
CHECKSUM_BYTES = 24      # ShardedIndex._same_positions: three int64 sums


def make_tier_index(view):
    """The seeded store of a tier's case with ``view`` fitted and armed."""
    from instsearch_torch import IndexConfig, PipelineConfig, SearchConfig
    from instsearch_torch.index import Index
    cfg = PipelineConfig(index=IndexConfig(dtype=TIER_VIEWS[view],
                                           row_tile=8,
                                           capacity=TIER_CAPACITY),
                         search=SearchConfig(k=TIER_K))
    idx = Index.from_descriptors(
        _unit(np.random.default_rng(41), (TIER_N, TIER_D)),
        [f"t{i}" for i in range(TIER_N)], cfg, device="cpu")
    if view == "pq":
        idx.build_pq(m=8, iters=3, sample=None, depth=TIER_DEPTH)
    elif view == "ivf":
        idx.build_ivf(n_clusters=8, nprobe=3, iters=3, sample=None)
    else:
        idx.build_ivfpq(n_clusters=8, nprobe=3, m=8, kmeans_iters=3,
                        pq_iters=3, sample=None, depth=TIER_DEPTH)
    return idx


def mutate_tier(idx) -> None:
    """A ``remove`` and an ``add``, which the view absorbs."""
    idx.remove(TIER_REMOVE)
    idx.add(descriptors=_unit(np.random.default_rng(47),
                              (TIER_ADDED, TIER_D)),
            names=[f"u{i}" for i in range(TIER_ADDED)])


TIER_MODES = ("plain", "qe")


def tier_search(idx, mode):
    """The tier's search of the seeded queries, plain or with αQE."""
    scfg = idx.cfg.search
    if mode == "qe":
        scfg = scfg.replace(qe_enabled=True, qe_n=TIER_QE)
    return idx.search(_unit(np.random.default_rng(43), (TIER_B, TIER_D)),
                      scfg)


def tier_rows_read(view, mode) -> list:
    """The positions each row read of a tier's search asks for, at most:
    the exact re-score's B x depth a cascade stage, αQE's B x qe_n."""
    bd, bq = TIER_B * TIER_DEPTH, TIER_B * TIER_QE
    if view == "ivf":
        return [bq] if mode == "qe" else []
    return [bd, bq, bd] if mode == "qe" else [bd]


def view_state(idx, view) -> dict:
    """The view's arrays (name -> numpy), which its absorbs write."""
    v = getattr(idx, view)
    if view == "pq":
        return {"packed": v.packed.numpy()}
    if view == "ivf":
        return {k: t.float().numpy() if t.dtype.is_floating_point
                else t.numpy() for k, t in v._state().items()}
    return {"bucket_pos": v.bucket_pos.numpy(),
            "spill_codes": v.spill_codes.numpy(),
            "spill_pos": v.spill_pos.numpy(),
            "spill_cluster": v.spill_cluster.numpy()}


def mutate(idx, donor, other) -> None:
    """The operations the workers and the test's twin run alike."""
    idx.remove(REMOVE)
    rng = np.random.default_rng(11)
    rows, reg = _unit(rng, (ADDED, D)), _unit(rng, (ADDED, R, D))
    idx.add(descriptors=rows, names=[f"n{i}" for i in range(ADDED)],
            **({"_regional_rows": reg} if idx.has_regional else {}))
    idx.merge_from(donor)
    idx.merge_from(other)


def main(rank: int, world: int, port: str, out: str) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=port)
    import torch
    import torch.distributed as dist
    from instsearch_torch.index import Index
    from instsearch_torch.parallel import global_shard_mesh, initialize
    assert initialize(backend="gloo")
    mesh = global_shard_mesh(["cpu"] * LOCAL_SHARDS)
    assert mesh.num_shards == world * LOCAL_SHARDS
    sent = [0]
    all_gather = dist.all_gather

    def counting(outs, tensor, *a, **kw):
        sent[0] += sum(t.numel() * t.element_size()
                       for t in list(outs) + [tensor])
        return all_gather(outs, tensor, *a, **kw)

    res = {}
    for kind in KINDS:
        path, donor_path = (os.path.join(out, kind),
                            os.path.join(out, f"{kind}_donor"))
        if rank == 0:
            make_index(kind).save(path, streaming=False)
            make_donor(kind, "d").save(donor_path, streaming=False)
        dist.barrier()
        idx = Index.load(path, mesh=mesh)
        donor = Index.load(donor_path, mesh=mesh)
        rem = sorted(idx.names.index(nm) for nm in REMOVE)
        new_valid = idx.num_valid - len(rem)
        holes = [p for p in rem if p < new_valid]
        survivors = [p for p in range(new_valid, idx.num_valid)
                     if p not in rem]
        row_bytes = sum(p[0].numel() // p[0].shape[0] * p[0].element_size()
                        if name != "scales" else p[0].element_size()
                        for name in STORES
                        for p in [idx._parts(name)] if p is not None)
        sent[0] = 0
        dist.all_gather = counting
        try:
            mutate(idx, donor, make_donor(kind, "u"))
        finally:
            dist.all_gather = all_gather
        assert idx.placed and donor.placed
        try:
            idx.add(descriptors=queries(kind)[:4].repeat(3, 0),
                    names=[f"x{i}" for i in range(12)],
                    **({"_regional_rows": np.zeros((12, R, D), np.float32)}
                       if idx.has_regional else {}))
            res[f"{kind}_past_capacity"] = "no error"
        except ValueError as e:
            res[f"{kind}_past_capacity"] = str(e)
        for name in STORES:
            parts = idx._parts(name)
            for j, p in enumerate(parts or ()):
                res[f"{kind}_{name}{j}"] = p.contiguous().view(
                    torch.uint8).numpy()
        res[f"{kind}_ids"] = idx.ids.numpy()
        res[f"{kind}_names"] = np.array(idx.names)
        s, i = idx.search(queries(kind))
        res[f"{kind}_search_s"], res[f"{kind}_search_i"] = s, i
        res[f"{kind}_holes"] = np.array(holes)
        res[f"{kind}_survivors"] = np.array(survivors)
        res[f"{kind}_n_pad"] = idx.n_pad
        res[f"{kind}_moved_bytes"] = (len(survivors) + DONOR) * row_bytes
        res[f"{kind}_store_bytes"] = idx.n_pad * row_bytes
        res[f"{kind}_all_gather_bytes"] = sent[0]
    res.update(tiers(rank, out, mesh, counting, sent))
    assert "jax" not in sys.modules
    np.savez(os.path.join(out, f"rank{rank}.npz"), **res)
    dist.destroy_process_group()
    print(f"MUTATE_OK {rank}", flush=True)


def tiers(rank, out, mesh, counting, sent) -> dict:
    """The candidate tiers on the placed stores across the processes: the
    views' absorbs, the searches with the bytes they move and their bound
    (each row read's positions x row bytes, padded at most to all of them,
    through ``world + 1`` tensors, plus the checksum), and the refusal of
    positions that differ between the processes."""
    import torch
    import torch.distributed as dist
    from instsearch_torch.index import Index
    res, all_gather = {}, dist.all_gather
    world = dist.get_world_size()
    for view in TIER_VIEWS:
        path = os.path.join(out, f"tier_{view}")
        if rank == 0:
            make_tier_index(view).save(path, streaming=False)
        dist.barrier()
        idx = Index.load(path, mesh=mesh)
        mutate_tier(idx)
        sh = idx.placement.shards[0]
        row_bytes = (sh.x.shape[1] * sh.x.element_size()
                     + sh.scales.element_size())
        for mode in TIER_MODES:
            sent[0] = 0
            dist.all_gather = counting
            try:
                s, i = tier_search(idx, mode)
            finally:
                dist.all_gather = all_gather
            res[f"tier_{view}_{mode}_s"], res[f"tier_{view}_{mode}_i"] = s, i
            res[f"tier_{view}_{mode}_bytes"] = sent[0]
            res[f"tier_{view}_{mode}_bound"] = sum(
                (world + 1) * (n * row_bytes + CHECKSUM_BYTES)
                for n in tier_rows_read(view, mode))
        res[f"tier_{view}_store_bytes"] = idx.n_pad * row_bytes
        res[f"tier_{view}_placed"] = idx.placed
        res[f"tier_{view}_names"] = np.array(idx.names)
        for name, a in view_state(idx, view).items():
            res[f"tier_{view}_view_{name}"] = a
    # positions that differ between the processes: a count, then a value
    for label, pos in (("count", torch.arange(rank + 1)),
                       ("value", torch.tensor([300 * rank]))):
        try:
            idx.placement.read_rows(pos)
            res[f"diverge_{label}"] = "no error"
        except RuntimeError as e:
            res[f"diverge_{label}"] = str(e)
    # the group still serves a read every process agrees on
    res["agreed_rows"] = idx.placement.read_rows(torch.arange(4))["x"].numpy()
    return res


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
