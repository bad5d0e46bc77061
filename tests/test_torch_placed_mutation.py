"""Mutating a placed store (``Index.load(mesh=)``) where it lies: ``add``
within capacity, ``remove``, ``merge_from``, the views absorbing both and
the views' fits run on the shards, with no gather (the reference writes its
sharded arrays in place: ``Index.load(mesh=make_mesh(8))``'s store stays
``P('shard')`` through them).

200 rows in a capacity of 256 at row tile 8 on ``make_mesh(8, devices=
["cpu"] * 8)``: 32 rows a shard, D = 40, bf16/f32/int8/int4, with an int8
regional store (R = 2) on the int8 index. Each is saved once (module
fixture) and every case loads it three ways: placed (with
``Index.gather`` patched on the instance to raise), unplaced (the twin)
and, where the reference is held, by the JAX package onto its eight
virtual devices. What is checked after each step:
  * the placed parts, joined, equal the twin's store byte for byte (bits,
    so a -0.0 counts), with ids, scales, regional rows and names equal;
  * search (with αQE, and the regional re-rank on int8), ``search_range``
    and ``full_ranking`` equal the twin's: ids and counts equal, scores
    within 1e-6 (a shard's f32 sums may take another order);
  * the reference's stored values (int4 through ``unpack_int4``), ids,
    scales and names equal the placed ones, and its store reads
    ``P('shard')``.
The steps: an ``add`` across a shard boundary, a ``remove`` moving rows
carrying planted -0.0 from the last shard into holes on four others, a
``remove`` emptying the last valid shard (no -1 id, no removed name comes
back), ``merge_from`` a placed and an unplaced donor. Apart: the PQ, IVF
(int8), IVF-PQ and local-whitening views loaded placed and absorbing
``add`` and ``remove``; the four fits on the placed store; ``ServeCore.
mutate``; ``save`` after the mutations (both forms) and its load; an
``add`` past capacity (it gathers, as the reference lands in
``SingleDeviceSharding``). Two gloo processes of
``tests/torch_mutation_worker.py`` (2 CPU shards each) run the same
``remove``/``add``/``merge_from``: each rank's parts equal its rows of the
twin, the bytes through ``all_gather`` stay within the moved rows' bytes x
world + 64 KiB, and an ``add`` past capacity raises ``ValueError``. The
same processes hold the candidate tiers (PQ and IVF-PQ on int4, IVF on
int8) on placed stores: after a ``remove`` and an ``add`` the views'
arrays (their absorbs read rows through the collective ``read_rows``) and
the tier searches, plain and with αQE, equal the single-process twins' on
both ranks; a search moves no more than its candidate rows through
``all_gather``; and positions that differ between the ranks raise
``RuntimeError`` on both instead of hanging.
"""
import contextlib
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_mutation_worker as worker
from instsearch_tpu.index import Index as JaxIndex
from instsearch_tpu.ops.quantize import unpack_int4 as jax_unpack_int4
from instsearch_tpu.parallel.mesh import make_mesh as jax_make_mesh
from instsearch_torch import IndexConfig, PipelineConfig, SearchConfig
from instsearch_torch.index import Index, attach_regional_store
from instsearch_torch.ops.quantize import unpack_int4
from instsearch_torch.parallel import make_mesh
from instsearch_torch.serve import ServeCore

N, CAPACITY, D, R, SHARDS = 200, 256, 40, 2, 8
C = CAPACITY // SHARDS
DONOR = 12
DTYPES = ("bfloat16", "float32", "int8", "int4")
STORES = ("descriptors", "scales", "regional", "regional_scales")


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """Small CPU tensors in a worker process: one intra-op thread,
    restored afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _mesh():
    return make_mesh(SHARDS, devices=["cpu"] * SHARDS)


def _unit(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _cfg(dtype, capacity=CAPACITY):
    return PipelineConfig(index=IndexConfig(dtype=dtype, row_tile=8,
                                            capacity=capacity),
                          search=SearchConfig(k=7, query_chunk=4))


def _data():
    rng = np.random.default_rng(2201)
    x = _unit(rng, (N, D))
    a = _unit(rng, (40, D))
    a[35, :4] = -0.0                    # planted: moved by the remove
    a[37, 9] = -0.0
    return {"x": x, "reg": _unit(rng, (N, R, D)), "a": a,
            "a_reg": _unit(rng, (40, R, D)), "q": x[[2, 77, 150, 199]]
            + 0.1 * _unit(rng, (4, D)), "donors": [
                (_unit(rng, (DONOR, D)), _unit(rng, (DONOR, R, D)))
                for _ in range(2)]}


def _build(dtype, rows, names, reg, capacity=CAPACITY):
    idx = Index.from_descriptors(rows, names, _cfg(dtype, capacity),
                                 device="cpu")
    if dtype == "int8":
        attach_regional_store(idx, reg)
    return idx


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """Each dtype's index and its two donors (``d*``, ``e*``) saved by the
    port in the npz form the reference reads too; the views' indexes."""
    tmp = tmp_path_factory.mktemp("placed_mutation")
    data = _data()
    paths = {}
    for dtype in DTYPES:
        _build(dtype, data["x"], [f"im{i}" for i in range(N)],
               data["reg"]).save(str(tmp / dtype))
        paths[dtype] = str(tmp / dtype)
        for tag, (rows, reg) in zip("de", data["donors"]):
            _build(dtype, rows, [f"{tag}{i}" for i in range(DONOR)], reg,
                   capacity=32).save(str(tmp / f"{dtype}_{tag}"))
            paths[dtype, tag] = str(tmp / f"{dtype}_{tag}")
    for view, dtype in VIEWS.items():
        idx = Index.load(paths[dtype], device="cpu")
        FITS[view](idx)
        idx.save(str(tmp / f"view_{view}"))
        paths[view] = str(tmp / f"view_{view}")
    return paths, data


@contextlib.contextmanager
def _no_gather(*indexes):
    """``Index.gather`` raising on these instances for the block."""
    def refuse():
        raise AssertionError("the placed store was gathered")
    with pytest.MonkeyPatch.context() as mp:
        for idx in indexes:
            mp.setattr(idx, "gather", refuse)
        yield


def _store(idx, name="descriptors"):
    """A store tensor, a placed index's parts joined in shard order."""
    if not idx.placed:
        return getattr(idx, name)
    parts = idx._parts(name)
    return None if parts is None else torch.cat(parts,
                                                1 if name == "scales" else 0)


def _bits(t):
    """A tensor's bytes (its shape and dtype kept apart by the callers'
    equality of the byte views' shapes)."""
    if not t.numel():
        return torch.empty(tuple(t.shape) + (0,), dtype=torch.uint8)
    return t.contiguous().view(torch.uint8)


def _same_answers(got, want):
    for a, b in zip(got, want):
        a, b = np.asarray(a), np.asarray(b)
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
        else:
            np.testing.assert_array_equal(a, b)


def _check_twin(placed, twin, q, qreg=None):
    """The placed store byte-equal to the twin's, the answers equal."""
    assert placed.placed and not twin.placed
    for name in STORES:
        a, b = _store(placed, name), getattr(twin, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert torch.equal(_bits(a), _bits(b)), name
    assert torch.equal(placed.ids, twin.ids)
    assert placed.names == twin.names
    counts = [sh.num_valid for sh in placed.placement.shards]
    assert counts == [max(0, min(twin.num_valid - j * C, C))
                      for j in range(SHARDS)]
    scfgs = [twin.cfg.search, twin.cfg.search.replace(qe_enabled=True,
                                                      qe_n=3)]
    for scfg in scfgs:
        _same_answers(placed.search(q, scfg), twin.search(q, scfg))
    if qreg is not None:
        scfg = twin.cfg.search.replace(rerank_enabled=True, rerank_depth=20)
        _same_answers(placed.search(q, scfg, query_regional=qreg),
                      twin.search(q, scfg, query_regional=qreg))
    _same_answers(placed.search_range(q, 0.2, max_results=16),
                  twin.search_range(q, 0.2, max_results=16))
    np.testing.assert_array_equal(placed.full_ranking(q),
                                  twin.full_ranking(q))


def _components(idx) -> np.ndarray:
    """The port's stored values up to ``dim`` (int4 unpacked), f32."""
    x = _store(idx)
    x = unpack_int4(x) if idx.is_int4 else x
    return x[:, :idx.dim].float().numpy()


def _check_reference(placed, ref):
    """The reference's store equal in values, ids, scales and names, and
    still sharded over ``'shard'``."""
    x = ref.descriptors
    want = np.asarray(jax_unpack_int4(x) if ref.is_int4 else x,
                      np.float32)
    np.testing.assert_array_equal(_components(placed), want)
    np.testing.assert_array_equal(placed.ids.numpy(), np.asarray(ref.ids))
    assert placed.names == list(ref.names)
    if ref.scales is not None:
        np.testing.assert_array_equal(_store(placed, "scales").numpy(),
                                      np.asarray(ref.scales))
        assert ref.scales.sharding.spec == P(None, "shard")
    for name in ("regional", "regional_scales"):
        if getattr(ref, name) is not None:
            np.testing.assert_array_equal(
                _store(placed, name).float().numpy(),
                np.asarray(getattr(ref, name), np.float32))
    assert ref.descriptors.sharding.spec == P("shard")


def _add(idx, rows, names, reg, dtype):
    kw = {"_regional_rows": reg} if dtype == "int8" else {}
    return idx.add(descriptors=rows, names=names, **kw)


@pytest.mark.parametrize("dtype", DTYPES)
def test_mutations_match_twin_and_reference(saved, dtype):
    paths, data = saved
    placed = Index.load(paths[dtype], mesh=_mesh())
    twin = Index.load(paths[dtype], device="cpu")
    ref = JaxIndex.load(paths[dtype], mesh=jax_make_mesh(SHARDS))
    q = data["q"]
    qreg = data["reg"][[2, 77, 150, 199]] if dtype == "int8" else None
    donors = {"d": Index.load(paths[dtype, "d"], mesh=_mesh()),
              "e": Index.load(paths[dtype, "e"], device="cpu")}
    ref_donors = {"d": JaxIndex.load(paths[dtype, "d"],
                                     mesh=jax_make_mesh(SHARDS)),
                  "e": JaxIndex.load(paths[dtype, "e"])}
    removed = []
    a_names = [f"a{i}" for i in range(40)]
    steps = [
        # rows 200..239: across the boundary of shards 6 and 7 (row 224)
        ("add", lambda i: _add(i, data["a"], a_names, data["a_reg"],
                               dtype)),
        # holes 3, 40, 70, 150 on shards 0, 1, 2, 4; survivors a35..a38
        # (rows 235..238, shard 7, -0.0 planted in a35 and a37)
        ("remove", ["im3", "im40", "im70", "im150", "a39"]),
        # 224 valid rows after it: shard 7 holds none
        ("remove", [f"a{i}" for i in range(29, 35)]
         + ["im10", "im50", "im100", "im120", "im199"]),
        ("merge", "d"), ("merge", "e")]
    for kind, arg in steps:
        for idx, is_ref in ((placed, False), (twin, False), (ref, True)):
            if kind == "add":
                got = arg(idx)
            elif kind == "remove":
                got = idx.remove(arg)
            else:
                got = idx.merge_from((ref_donors if is_ref else donors)[arg])
            if idx is placed:
                want = got
            assert got == want
        if kind == "remove":
            removed += arg
        with _no_gather(placed, donors["d"]):
            _check_twin(placed, twin, q, qreg)
        _check_reference(placed, ref)
        if kind == "remove" and arg[0] == "im3" and dtype in ("bfloat16",
                                                               "float32"):
            x = _store(placed)
            assert placed.names[3] == "a35" and placed.names[70] == "a37"
            assert torch.signbit(x[3, :4]).all()
            assert torch.signbit(x[70, 9])
        if kind == "remove" and arg[0] == "a29":
            assert placed.num_valid == 7 * C
            assert placed.placement.shards[7].num_valid == 0
            # the removed rows as queries: survivors only come back
            vec = {**{f"im{i}": r for i, r in enumerate(data["x"])},
                   **{nm: r for nm, r in zip(a_names, data["a"])}}
            with _no_gather(placed):
                _, ids = placed.search(np.stack([vec[nm] for nm in removed]))
            assert (ids >= 0).all()
            assert not {placed.name_of(i) for i in ids.reshape(-1)} \
                & set(removed)
    assert placed.placed and donors["d"].placed


@pytest.fixture
def views_pair(saved, request):
    paths, _ = saved
    path = paths[request.param]
    return (request.param, Index.load(path, mesh=_mesh()),
            Index.load(path, device="cpu"))


VIEWS = {"pq": "bfloat16", "ivf": "int8", "ivfpq": "int4", "lw": "float32"}
FITS = {"pq": lambda i: i.build_pq(m=4, iters=2, sample=None, depth=16),
        "ivf": lambda i: i.build_ivf(n_clusters=4, nprobe=2, iters=2,
                                     sample=None),
        "ivfpq": lambda i: i.build_ivfpq(n_clusters=4, nprobe=2, m=4,
                                         kmeans_iters=2, pq_iters=2,
                                         sample=None, depth=24),
        "lw": lambda i: i.fit_local_whitening(n_clusters=2, iters=2)}


def _view_state(idx, view: str) -> dict:
    v = getattr(idx, view)
    if view == "pq":
        return {"packed": v.packed}
    if view == "lw":
        return {"store": v.store, "assign": v.assign, "P": v.params.P}
    if view == "ivf":
        return dict(zip(("centroids", "buckets", "bucket_scales",
                         "bucket_pos", "spill", "spill_scales",
                         "spill_pos"), v.arrays))
    return {"codes": v.codes, "bucket_pos": v.bucket_pos,
            "spill_codes": v.spill_codes, "spill_pos": v.spill_pos,
            "spill_cluster": v.spill_cluster, "centroids": v.centroids}


def _same_views(a, b, view):
    sa, sb = _view_state(a, view), _view_state(b, view)
    for k in sa:
        if sa[k] is None:
            assert sb[k] is None, k
        else:
            assert torch.equal(_bits(sa[k]), _bits(sb[k])), k


@pytest.mark.parametrize("views_pair", list(VIEWS), indirect=True)
def test_views_absorb_add_and_remove(saved, views_pair):
    view, placed, twin = views_pair
    _, data = saved
    reg = data["a_reg"][:20]
    for idx in (placed, twin):
        with _no_gather(placed):
            _add(idx, data["a"][:20], [f"a{i}" for i in range(20)], reg,
                 VIEWS[view])
            idx.remove(["im0", "im31", "im64", "a19", "a2"])
            _add(idx, data["a"][20:25], [f"a{i}" for i in range(20, 25)],
                 data["a_reg"][20:25], VIEWS[view])
    assert placed.placed
    _same_views(placed, twin, view)
    for name in STORES:
        a, b = _store(placed, name), getattr(twin, name)
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(_bits(a), _bits(b))
    q = data["q"]
    if view == "lw":                 # re-scored through the placement
        with _no_gather(placed):
            _same_answers(placed.search(q), twin.search(q))
        assert placed.placed
        assert placed.placement.shards[0].lw_store.data_ptr() \
            == placed.lw.store.data_ptr()
    else:                            # an armed tier gathers to search
        _same_answers(placed.search(q), twin.search(q))


@pytest.mark.parametrize("view", list(VIEWS))
def test_fits_on_the_placed_store(saved, view):
    paths, data = saved
    placed = Index.load(paths[VIEWS[view]], mesh=_mesh())
    twin = Index.load(paths[VIEWS[view]], device="cpu")
    with _no_gather(placed):
        FITS[view](placed)
    FITS[view](twin)
    assert placed.placed
    _same_views(placed, twin, view)
    assert placed.cfg.search == twin.cfg.search
    if view in ("lw", "ivfpq"):     # the placement carries these views
        sidx = placed.placement
        assert (sidx.lw_params is not None) == (view == "lw")
        assert (sidx.ivfpq is not None) == (view == "ivfpq")
    with _no_gather(placed):
        off = twin.cfg.search.replace(pq_depth=0, ivf_nprobe=0,
                                      ivfpq_nprobe=0)
        _same_answers(placed.search(data["q"], off),
                      twin.search(data["q"], off))


class _TableExtractor:
    """An extractor stand-in for the ``paths=`` route: each file's row by
    its name, from a table (the store's rows are what is under test)."""

    def __init__(self, table: dict):
        self.table, self.whitening = table, None
        self.device = torch.device("cpu")

    def extract_paths(self, paths, quarantine):
        keys = [os.path.splitext(os.path.basename(p))[0] for p in paths]
        return np.stack([self.table[k] for k in keys]), list(range(len(keys)))


def test_serve_core_mutate_keeps_the_placement(saved):
    paths, data = saved
    table = {f"s{i}": r for i, r in enumerate(data["a"][:30])}
    placed = Index.load(paths["bfloat16"], mesh=_mesh())
    twin = Index.load(paths["bfloat16"], device="cpu")
    cores = []
    for idx in (placed, twin):
        idx.extractor = _TableExtractor(table)
        cores.append(ServeCore(idx, sharded=True, mesh=_mesh()
                               if idx is twin else placed.placement.mesh))
    reqs = [{"add": [f"/img/s{i}.png" for i in range(30)]},
            {"remove": ["im5", "im100", "s29", "s3"]},
            {"add": [f"/img/s{i}.png" for i in range(29, 30)]}]
    for req in reqs:
        with _no_gather(placed):
            got = [c.mutate(req) for c in cores]
        assert got[0]["rows"] == got[1]["rows"]
        assert placed.placed
        sidx = cores[0].sidx
        for sh, part in zip(sidx.shards, placed.placement.shards,
                            strict=True):
            assert sh.x.data_ptr() == part.x.data_ptr()
            assert sh.num_valid == part.num_valid
        with _no_gather(placed):
            _check_twin(placed, twin, data["q"])
            _same_answers(sidx.search(torch.as_tensor(data["q"]), k=5),
                          cores[1].sidx.search(torch.as_tensor(data["q"]),
                                               k=5))


def _saved_arrays(path):
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    if meta["format"] == "npz":
        npz = np.load(os.path.join(path, "index.npz"))
        arrays = {k: npz[k] for k in npz.files}
    else:
        from instsearch_torch.utils.checkpoint import open_tree
        arrays = {k: leaf[...] for k, leaf in
                  open_tree(os.path.join(path, "store")).items()}
    return meta, arrays


@pytest.mark.parametrize("streaming", [True, False])
def test_save_after_mutation_equals_the_twins(saved, streaming, tmp_path):
    paths, data = saved
    placed = Index.load(paths["int8"], mesh=_mesh())
    twin = Index.load(paths["int8"], device="cpu")
    donors = (Index.load(paths["int8", "d"], mesh=_mesh()),
              Index.load(paths["int8", "d"], device="cpu"))
    for idx, donor in zip((placed, twin), donors):
        with _no_gather(placed, donors[0]):
            _add(idx, data["a"][:30], [f"a{i}" for i in range(30)],
                 data["a_reg"][:30], "int8")
            idx.remove(["im1", "a29", "im180", "a0"])
            idx.merge_from(donor)
            idx.save(str(tmp_path / ("placed" if idx is placed else "twin")),
                     streaming=streaming)
    assert placed.placed
    (ma, a), (mb, b) = (_saved_arrays(str(tmp_path / t))
                        for t in ("placed", "twin"))
    assert ma == mb and a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    back = Index.load(str(tmp_path / "placed"), mesh=_mesh())
    with _no_gather(back):
        _check_twin(back, twin, data["q"], data["reg"][:4])


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_add_past_capacity_gathers(saved, dtype):
    """Past capacity the placed store is gathered and re-padded on one
    device (the reference's store lands in ``SingleDeviceSharding``), equal
    to the twin's."""
    paths, data = saved
    placed = Index.load(paths[dtype], mesh=_mesh())
    twin = Index.load(paths[dtype], device="cpu")
    ref = JaxIndex.load(paths[dtype], mesh=jax_make_mesh(SHARDS))
    rows = np.concatenate([data["a"], data["a"][:30]])
    reg = np.concatenate([data["a_reg"], data["a_reg"][:30]])
    names = [f"p{i}" for i in range(70)]
    for idx in (placed, twin, ref):
        assert _add(idx, rows, names, reg, dtype) == 70
    assert not placed.placed and placed.n_pad == twin.n_pad == 2 * CAPACITY
    for name in STORES:
        a, b = getattr(placed, name), getattr(twin, name)
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(_bits(a), _bits(b))
    assert torch.equal(placed.ids, twin.ids) and placed.names == twin.names
    assert type(ref.descriptors.sharding).__name__ == "SingleDeviceSharding"
    np.testing.assert_array_equal(placed.ids.numpy(), np.asarray(ref.ids))
    _same_answers(placed.search(data["q"]), twin.search(data["q"]))


# ---- across processes -------------------------------------------------------
WORLD = 2


@pytest.fixture(scope="module")
def two_processes(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_placed_mutation")
    with socket.socket() as s:                 # a free loopback port
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")}
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, worker.__file__, str(r), str(WORLD), str(port),
         str(out)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env) for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0 and f"MUTATE_OK {r}" in log, \
            f"worker {r} failed:\n{log[-3000:]}"
    return out, [dict(np.load(out / f"rank{r}.npz")) for r in range(WORLD)]


@pytest.fixture(scope="module")
def twins(two_processes):
    """The single-process twins of the workers' indexes, through the same
    operations, from the files rank 0 wrote."""
    out, _ = two_processes
    res = {}
    for kind in worker.KINDS:
        idx = Index.load(str(out / kind), device="cpu")
        donor = Index.load(str(out / f"{kind}_donor"), device="cpu")
        worker.mutate(idx, donor, worker.make_donor(kind, "u"))
        res[kind] = idx
    return res


@pytest.mark.parametrize("kind", worker.KINDS)
def test_two_processes_hold_the_twins_rows(two_processes, twins, kind):
    _, ranks = two_processes
    twin = twins[kind]
    per = twin.n_pad // (WORLD * worker.LOCAL_SHARDS)
    for r, res in enumerate(ranks):
        for j in range(worker.LOCAL_SHARDS):
            rows = slice((r * worker.LOCAL_SHARDS + j) * per,
                         (r * worker.LOCAL_SHARDS + j + 1) * per)
            for name in STORES:
                key = f"{kind}_{name}{j}"
                want = getattr(twin, name)
                assert (key in res) == (want is not None)
                if want is not None:
                    want = want[:, rows] if name == "scales" else want[rows]
                    np.testing.assert_array_equal(res[key], _bits(
                        want).numpy())
        np.testing.assert_array_equal(res[f"{kind}_ids"], twin.ids.numpy())
        assert res[f"{kind}_names"].tolist() == twin.names
        s, i = twin.search(worker.queries(kind))
        np.testing.assert_array_equal(res[f"{kind}_search_i"], i)
        np.testing.assert_allclose(res[f"{kind}_search_s"], s, rtol=0,
                                   atol=1e-6)


@pytest.mark.parametrize("kind", worker.KINDS)
def test_two_processes_move_only_the_moved_rows(two_processes, kind):
    """The remove's holes lie on rank 0, its survivors on rank 1; what
    crosses ``all_gather`` stays within the moved rows' bytes x world +
    64 KiB (a gather of the store would not: it holds several times
    that), and an ``add`` past capacity raises ``ValueError``."""
    _, ranks = two_processes
    for res in ranks:
        holes, survivors = res[f"{kind}_holes"], res[f"{kind}_survivors"]
        half = res[f"{kind}_n_pad"] // WORLD
        assert len(holes) and (holes < half).all() and (survivors
                                                        >= half).all()
        moved = int(res[f"{kind}_moved_bytes"])
        sent = int(res[f"{kind}_all_gather_bytes"])
        assert 0 < sent <= moved * WORLD + (64 << 10), (sent, moved)
        assert int(res[f"{kind}_store_bytes"]) > moved * WORLD + (64 << 10)
        assert "capacity" in str(res[f"{kind}_past_capacity"])


@pytest.fixture(scope="module")
def tier_twins(two_processes):
    """The single-process twins of the workers' tier cases, from the files
    rank 0 wrote: loaded unplaced, the same mutations, the same
    searches."""
    out, _ = two_processes
    res = {}
    for view in worker.TIER_VIEWS:
        idx = Index.load(str(out / f"tier_{view}"), device="cpu")
        worker.mutate_tier(idx)
        res[view] = (idx, {mode: worker.tier_search(idx, mode)
                           for mode in worker.TIER_MODES})
    return res


@pytest.mark.parametrize("view", list(worker.TIER_VIEWS))
def test_two_processes_tiers_equal_the_twins(two_processes, tier_twins,
                                             view):
    """The views' arrays after the absorbs, and the tier searches plain and
    with αQE, equal the twin's on both ranks; the stores stay placed."""
    _, ranks = two_processes
    twin, answers = tier_twins[view]
    for res in ranks:
        assert bool(res[f"tier_{view}_placed"])
        assert res[f"tier_{view}_names"].tolist() == twin.names
        state = worker.view_state(twin, view)
        for name, want in state.items():
            np.testing.assert_array_equal(res[f"tier_{view}_view_{name}"],
                                          want)
        for mode, (s, i) in answers.items():
            np.testing.assert_array_equal(res[f"tier_{view}_{mode}_i"], i)
            np.testing.assert_allclose(res[f"tier_{view}_{mode}_s"], s,
                                       rtol=0, atol=1e-6)


@pytest.mark.parametrize("view", list(worker.TIER_VIEWS))
def test_two_processes_tiers_move_only_candidate_rows(two_processes, view):
    """What a tier search moves through ``all_gather`` stays within its
    row reads' bound (B x depth rows a cascade stage, B x qe_n for αQE,
    each padded at most to all of them), far below the store a gather
    would move; the IVF scan alone reads no row."""
    _, ranks = two_processes
    for res in ranks:
        store = int(res[f"tier_{view}_store_bytes"])
        for mode in worker.TIER_MODES:
            sent = int(res[f"tier_{view}_{mode}_bytes"])
            bound = int(res[f"tier_{view}_{mode}_bound"])
            assert sent <= bound < store, (mode, sent, bound, store)
            assert (sent == 0) == (view == "ivf" and mode == "plain")


def test_two_processes_refuse_different_positions(two_processes):
    """``read_rows`` given another count, then another value, on each rank
    raises ``RuntimeError`` on both ranks (the fixture's timeout would
    catch a hang); the group then serves an agreed read."""
    _, ranks = two_processes
    for res in ranks:
        for label in ("count", "value"):
            assert "different positions" in str(res[f"diverge_{label}"])
    np.testing.assert_array_equal(ranks[0]["agreed_rows"],
                                  ranks[1]["agreed_rows"])
