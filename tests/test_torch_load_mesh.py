"""``Index.load(path, mesh=)``: the store placed shard by shard as it loads
(the reference's ``load(mesh=)``, tests/integration/test_persistence.py::
test_npz_load_honors_mesh), on ``make_mesh(8, devices=["cpu"] * 8)``.

120 rows in a capacity of 128 (row tile 8: 16 rows a shard, the last one
all padding) at D = 40, bf16/f32/int8/int4, with an int8 regional store on
the int8 index. What is checked:
  * placement: each shard's part holds exactly its rows of the unsharded
    load's store, scales and regional store (byte-equal), and no
    whole-store tensor exists until an operation that gathers;
  * ``to_sharded`` with the same mesh (or none) reuses the parts
    (``data_ptr`` equal);
  * serving on the placed index (``search`` with and without αQE and the
    regional re-rank, ``query``, ``search_range``, ``knn_graph``,
    ``find_duplicates``, ``full_ranking``, ``reconstruct``, ``stats``)
    equals the unsharded load's and leaves the placement in place: ids and
    counts equal, scores within 1e-6 (a shard's f32 sums may take another
    order than the whole store's, as on every sharded route);
  * ``add`` within capacity, ``remove``, ``merge_from``, the PQ, IVF
    and local-whitening fits and a search through an armed candidate tier
    keep the store placed; ``augment_database``, ``attach_regional_store``
    and an ``add`` past capacity gather it (the reference's own results
    leave its placement there too); each gives the unsharded load's
    result (tests/test_torch_placed_mutation.py holds the placed mutations
    in full, tests/test_torch_placed_tiers.py the tiers' searches);
  * a JAX-written npz loaded with a mesh answers as the JAX Index (ids
    equal, scores within 1e-5), a 2-D mesh places over its ``'shard'``
    axis, a process group of one (gloo) places its own shards, and rows
    that do not divide among the shards are refused.
"""
import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist

from instsearch_tpu import IndexConfig as JaxIndexConfig
from instsearch_tpu import PipelineConfig as JaxPipelineConfig
from instsearch_tpu import SearchConfig as JaxSearchConfig
from instsearch_tpu.index import Index as JaxIndex
from instsearch_torch import IndexConfig, PipelineConfig, SearchConfig
from instsearch_torch.index import Index, attach_regional_store
from instsearch_torch.parallel import make_mesh, make_mesh_2d

N, CAPACITY, D, R = 120, 128, 40, 3
DTYPES = ("bfloat16", "float32", "int8", "int4")


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """Small CPU tensors in a worker process: one intra-op thread,
    restored afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _mesh(n=8, group=None):
    return make_mesh(n, devices=["cpu"] * n, group=group)


def _unit(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _rows(seed=0):
    rng = np.random.default_rng(700 + seed)
    x = _unit(rng, (N, D))
    x[7] = x[3]                               # a duplicate pair
    q = x[[2, 40, 90]] + 0.2 * rng.standard_normal((3, D)).astype(
        np.float32)
    return x, q, _unit(rng, (N, R, D)), _unit(rng, (3, R, D))


def _cfg(dtype):
    return PipelineConfig(index=IndexConfig(dtype=dtype, row_tile=8,
                                            capacity=CAPACITY),
                          search=SearchConfig(k=7, query_chunk=2))


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """Each dtype's index saved by the port (the int8 one with a regional
    store), and the JAX package's f32 index saved in its npz form."""
    tmp = tmp_path_factory.mktemp("load_mesh")
    x, _, reg, _ = _rows()
    names = [f"im{i}" for i in range(N)]
    paths = {}
    for dtype in DTYPES:
        idx = Index.from_descriptors(x, names, _cfg(dtype), device="cpu")
        if dtype == "int8":
            attach_regional_store(idx, reg)
        idx.save(str(tmp / dtype))
        paths[dtype] = str(tmp / dtype)
    jidx = JaxIndex.from_descriptors(x, names, JaxPipelineConfig(
        index=JaxIndexConfig(dtype="float32", row_tile=8, capacity=CAPACITY),
        search=JaxSearchConfig(k=7)))
    jidx.save(str(tmp / "jax"), streaming=False)
    paths["jax"] = str(tmp / "jax")
    return paths, jidx


def _same(got, want):
    """Integer arrays (ids, counts) equal; scores within 1e-6."""
    for a, b in zip(got, want):
        a, b = np.asarray(a), np.asarray(b)
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
        else:
            np.testing.assert_array_equal(a, b)


def _load_both(path, mesh=None):
    return (Index.load(path, device="cpu"),
            Index.load(path, mesh=mesh or _mesh()))


@pytest.mark.parametrize("dtype", DTYPES)
def test_each_shard_holds_its_rows(saved, dtype):
    whole, placed = _load_both(saved[0][dtype])
    assert placed.placed and placed.descriptors is None
    assert placed.scales is None and placed.regional is None
    assert placed.n_pad == CAPACITY and placed.dim == D
    assert placed.store_dim == whole.store_dim
    assert placed.has_regional == whole.has_regional == (dtype == "int8")
    c = CAPACITY // 8
    for j, sh in enumerate(placed.placement.shards):
        rows = slice(j * c, (j + 1) * c)
        assert torch.equal(sh.x, whole.descriptors[rows])
        if whole.scales is not None:
            assert torch.equal(sh.scales, whole.scales[:, rows])
        if dtype == "int8":
            assert torch.equal(sh.regional, whole.regional[rows])
            assert torch.equal(sh.regional_scales,
                               whole.regional_scales[rows])
        else:
            assert sh.regional is None
    assert placed.stats() == whole.stats()
    assert placed.placed


def test_to_sharded_copies_nothing(saved):
    _, placed = _load_both(saved[0]["int8"])
    mesh = placed.placement.mesh
    parts = placed.placement.shards
    for sidx in (placed.to_sharded(), placed.to_sharded(mesh=mesh),
                 placed.with_search(k=3).placement):
        for sh, p in zip(sidx.shards, parts, strict=True):
            assert sh.x.data_ptr() == p.x.data_ptr()
            assert sh.scales.data_ptr() == p.scales.data_ptr()
            assert sh.regional.data_ptr() == p.regional.data_ptr()
            assert (sh.regional_scales.data_ptr()
                    == p.regional_scales.data_ptr())
    assert placed.placed


@pytest.mark.parametrize("dtype", DTYPES)
def test_serving_equals_unsharded_load(saved, dtype):
    x, q, _, qreg = _rows()
    whole, placed = _load_both(saved[0][dtype])
    for route in (True, False):
        w = whole.with_search(use_pallas=route)
        p = placed.with_search(use_pallas=route)
        scfgs = [w.cfg.search, w.cfg.search.replace(qe_enabled=True,
                                                    qe_n=4)]
        for scfg in scfgs:
            _same(p.search(q, scfg), w.search(q, scfg))
        if dtype == "int8":
            scfg = w.cfg.search.replace(rerank_enabled=True, rerank_depth=20)
            _same(p.search(q, scfg, query_regional=qreg),
                  w.search(q, scfg, query_regional=qreg))
        _same(p.query(q, k=3), w.query(q, k=3))
        _same(p.search_range(q, 0.3, max_results=16),
              w.search_range(q, 0.3, max_results=16))
        _same(p.knn_graph(k=4, chunk=16), w.knn_graph(k=4, chunk=16))
    pairs = placed.find_duplicates(tau=0.99)
    np.testing.assert_array_equal(pairs[0], whole.find_duplicates(
        tau=0.99)[0])
    assert pairs[0].tolist() == [[3, 7]]
    np.testing.assert_array_equal(placed.full_ranking(q),
                                  whole.full_ranking(q))
    np.testing.assert_array_equal(placed.reconstruct(ids=[5, 0, 119]),
                                  whole.reconstruct(ids=[5, 0, 119]))
    assert placed.placed


def _store(idx, name="descriptors"):
    """A store tensor of an index, its placed parts joined in shard
    order."""
    if not idx.placed:
        return getattr(idx, name)
    parts = idx._parts(name)
    return None if parts is None else torch.cat(parts,
                                                1 if name == "scales" else 0)


@pytest.mark.parametrize("op", ["within_capacity", "past_capacity"])
def test_whole_store_operations_gather(saved, op):
    """``remove``, ``add`` within capacity and ``merge_from`` keep a placed
    store placed (the reference writes its sharded arrays in place); an
    ``add`` past capacity gathers it and re-pads on one device, as the
    reference's re-pad lands on one device. Either way the store, scales,
    names and answers equal the unsharded load's."""
    x, q, _, _ = _rows()
    _, q2, _, _ = _rows(seed=1)
    donor = Index.from_descriptors(q2, ["d0", "d1", "d2"], _cfg("int4"),
                                   device="cpu")
    extra = 0 if op == "within_capacity" else CAPACITY
    results = []
    for idx in _load_both(saved[0]["int4"]):
        idx.remove(["im3", "im50"])
        idx.add(descriptors=np.tile(x, (3, 1))[:2 + extra] * -1.0,
                names=[f"n{i}" for i in range(2 + extra)])
        idx.merge_from(donor)
        results.append((idx, idx.search(q), _store(idx),
                        _store(idx, "scales"), idx.names))
    (pw, a, *ta), (pp, b, *tb) = results
    assert pp.placed == (op == "within_capacity")
    assert pp.n_pad == (CAPACITY if op == "within_capacity" else 2 * CAPACITY)
    _same(a, b)
    for u, v in zip(ta[:2], tb[:2]):
        assert torch.equal(u, v)
    assert ta[2] == tb[2]


@pytest.mark.parametrize("op", ["build_pq", "build_ivf", "augment_database",
                                "fit_local_whitening",
                                "attach_regional_store"])
def test_view_fits_and_rewrites_gather(saved, op):
    """The views' fits read a placed store through its placement and keep
    it placed; the store rewrites (``augment_database``,
    ``attach_regional_store``) gather it first, as the reference's own
    results leave its placement (a replicated store, a regional store on
    one device). Either way the answers equal the unsharded load's (ids
    and counts; scores within 1e-6) and the stores are equal."""
    _, q, reg, _ = _rows()
    run = {"build_pq": lambda i: i.build_pq(m=4, iters=2, sample=None,
                                            depth=16),
           "build_ivf": lambda i: i.build_ivf(n_clusters=4, nprobe=2,
                                              iters=2, sample=None),
           "augment_database": lambda i: i.augment_database(n=3),
           "fit_local_whitening": lambda i: i.fit_local_whitening(
               n_clusters=2, iters=2),
           "attach_regional_store": lambda i: attach_regional_store(
               i, reg[:, :2])}[op]
    stays = op in ("build_pq", "build_ivf", "fit_local_whitening")
    results = []
    for idx in _load_both(saved[0]["int8"]):
        run(idx)
        results.append((idx.placed, _store(idx), _store(idx, "regional")))
        results[-1] += (idx.search(q),)
    (wp, *ta, a), (pp, *tb, b) = results
    assert not wp and pp == stays
    _same(a, b)
    for u, v in zip(ta, tb):
        assert torch.equal(u, v)


def test_armed_tier_on_a_placed_load_stays_placed(saved, tmp_path,
                                                  monkeypatch):
    """An index saved with an armed PQ view and loaded placed: a search
    through the cascade reads its candidates' rows from the shards and
    keeps the store placed (the reference's store stays ``P('shard')``
    there too), with the unsharded answers; with the tier off it serves
    placed too. ``Index.gather`` raises on the placed instance."""
    _, q, _, _ = _rows()
    whole = Index.load(saved[0]["int8"], device="cpu")
    whole.build_pq(m=4, iters=2, sample=None, depth=16)
    whole.save(str(tmp_path))
    placed = Index.load(str(tmp_path), mesh=_mesh())

    def refuse():
        raise AssertionError("the placed store was gathered")
    monkeypatch.setattr(placed, "gather", refuse)
    off = placed.cfg.search.replace(pq_depth=0)
    _same(placed.search(q, off), whole.search(q, off))
    assert placed.placed
    _same(placed.search(q), whole.search(q))
    assert placed.placed


def test_jax_npz_loaded_with_mesh(saved):
    paths, jidx = saved
    _, q, _, _ = _rows()
    placed = Index.load(paths["jax"], mesh=_mesh())
    assert placed.placed
    js, ji = jidx.search(q)
    ts, ti = placed.with_search(use_pallas=False).search(q)
    np.testing.assert_array_equal(ti, np.asarray(ji))
    np.testing.assert_allclose(ts, np.asarray(js), rtol=0, atol=1e-5)
    ks, ki = placed.search(q)                  # the kernels' plain route
    np.testing.assert_array_equal(ki, np.asarray(ji))
    assert (ti[:, 0] == [2, 40, 90]).all()


def test_2d_mesh_places_over_its_shard_axis(saved):
    _, q, _, _ = _rows()
    whole, placed = _load_both(saved[0]["bfloat16"],
                               mesh=make_mesh_2d(2, 4,
                                                 devices=["cpu"] * 8))
    assert placed.placement.mesh.axis == "shard"
    assert len(placed.placement.shards) == 4
    _same(placed.search(q), whole.search(q))


def test_group_of_one_places_its_own_shards(saved):
    _, q, _, _ = _rows()
    if dist.is_initialized():
        pytest.fail("a process group is already up in this worker")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    try:
        whole, placed = _load_both(
            saved[0]["int4"], mesh=_mesh(4, group=dist.group.WORLD))
        assert placed.placement.mesh.group is not None
        _same(placed.search(q), whole.search(q))
        _same(placed.search_range(q, 0.3), whole.search_range(q, 0.3))
        placed.remove(["im1"])         # moves through the group, placed
        whole.remove(["im1"])
        assert placed.placed
        assert torch.equal(_store(placed), whole.descriptors)
        _same(placed.search(q), whole.search(q))
    finally:
        dist.destroy_process_group()


def test_rows_that_do_not_divide_are_refused(saved):
    with pytest.raises(ValueError, match="do not divide"):
        Index.load(saved[0]["float32"], mesh=_mesh(3))
