"""The port's stream form of ``Index.save`` / ``Index.load`` (``format:
"npy_stream"``: ``store/`` a sharded tree of ``utils/checkpoint.py``).

The stores: 120 seeded rows in a capacity of 128 (row tile 8) at D = 40
(the kernels' zero columns take bf16/f32 to 40, int8 to 48, int4 to 64),
as f32, bf16, int8 and int4; bf16 with a bf16 regional store and int8 with
an int8 one; an f32 l2 store; an int8 store with the IVF and
local-whitening views, one with a PQ view and one with an IVF-PQ view. One
module-scoped fixture saves each once in both forms (``streaming=True`` and
``False``).

What is checked:
  * each stream loads with no mesh, on ``["cpu"] * 4`` and over a 2-D
    mesh's ``'shard'`` axis: the store, row scales, regional store and ids
    equal the saved index's bit for bit (a placed shard its rows), the
    stream holds the reference's arrays at the reference's width and
    storage dtype (bf16 not widened), and ``search`` equals the npz load's
    answers on the same mesh exactly (the same bytes, the same route);
  * ``streaming=None`` takes the form the reference takes on the same rows
    (tests/integration/test_persistence.py:93-121): a store just over the
    8 MiB cutoff streams, one just under it does not, and a small store
    with a large regional store streams; the JAX Index saves the same rows
    alongside;
  * through an instrumented memory map: a placed load reads, and a placed
    save writes, at most one shard's rows of a store array at a time;
  * a missing or short ``store/`` file raises, an ``index.npz`` beside it
    notwithstanding.
"""
import json
import os
import shutil

import numpy as np
import pytest
import torch

from instsearch_tpu import IndexConfig as JaxIndexConfig
from instsearch_tpu import PipelineConfig as JaxPipelineConfig
from instsearch_tpu.index import Index as JaxIndex
from instsearch_tpu.index import attach_regional_store as jax_attach
from instsearch_torch import IndexConfig, PipelineConfig, SearchConfig
from instsearch_torch.index import Index, attach_regional_store
from instsearch_torch.parallel import make_mesh, make_mesh_2d
from instsearch_torch.utils import checkpoint

N, CAPACITY, D, R = 120, 128, 40, 3
CASES = ("float32", "bfloat16", "int8", "int4", "bfloat16_regional",
         "int8_regional", "l2", "int8_ivf_lw", "int8_pq", "int4_ivfpq")
MESHES = ("none", "cpu4", "2d")
STORE_NAMES = {"descriptors", "descriptors_int8", "descriptors_int4",
               "scales", "regional", "regional_int8", "regional_scales"}


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """Small CPU tensors in a worker process: one intra-op thread,
    restored afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _unit(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _data():
    rng = np.random.default_rng(31)
    x = _unit(rng, (N, D))
    q = x[[4, 60, 111]] + 0.1 * rng.standard_normal((3, D)).astype(
        np.float32)
    return x, q, _unit(rng, (N, R, D)), _unit(rng, (3, R, D))


def _index(case: str) -> Index:
    x, _, reg, _ = _data()
    dtype = {"l2": "float32"}.get(case, case.split("_")[0])
    icfg = dict(dtype=dtype, row_tile=8, capacity=CAPACITY)
    if case == "l2":
        x = x * 3.0
        icfg["metric"] = "l2"
    idx = Index.from_descriptors(
        x, [f"im{i}" for i in range(N)],
        PipelineConfig(index=IndexConfig(**icfg),
                       search=SearchConfig(k=7, query_chunk=2)),
        device="cpu")
    if case.endswith("regional"):
        attach_regional_store(idx, reg)
    if "ivf_lw" in case:
        idx.build_ivf(n_clusters=4, nprobe=2, iters=2, sample=None)
        idx.fit_local_whitening(n_clusters=2, iters=2)
    if case.endswith("_pq"):
        idx.build_pq(m=4, iters=2, sample=None, depth=16)
    if case.endswith("ivfpq"):
        idx.build_ivfpq(n_clusters=4, nprobe=2, m=4, kmeans_iters=2,
                        pq_iters=2, sample=None, depth=32)
    return idx


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """case -> (the index, its stream path, its npz path)."""
    tmp = tmp_path_factory.mktemp("stream_store")
    out = {}
    for case in CASES:
        idx = _index(case)
        stream, npz = str(tmp / f"{case}_stream"), str(tmp / f"{case}_npz")
        idx.save(stream, streaming=True)
        idx.save(npz, streaming=False)
        out[case] = (idx, stream, npz)
    return out


def _mesh(kind):
    return {"none": None, "cpu4": make_mesh(4, devices=["cpu"] * 4),
            "2d": make_mesh_2d(2, 4, devices=["cpu"] * 8)}[kind]


def _load(path, kind):
    mesh = _mesh(kind)
    return (Index.load(path, device="cpu") if mesh is None
            else Index.load(path, mesh=mesh))


def _store(idx, name):
    """A store tensor of ``idx`` whole (a placed one's parts joined)."""
    if not idx.placed:
        return getattr(idx, name)
    parts = idx._parts(name)
    return None if parts is None else torch.cat(
        parts, 1 if name == "scales" else 0)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("case", CASES)
def test_stream_round_trip(saved, case, mesh):
    idx, stream, npz = saved[case]
    meta = json.load(open(os.path.join(stream, "meta.json")))
    assert meta["format"] == Index.STREAM_FORMAT
    assert not os.path.exists(os.path.join(stream, "index.npz"))
    tree = checkpoint.open_tree(os.path.join(stream, "store"))
    key = ("descriptors_int4" if idx.is_int4 else "descriptors_int8"
           if idx.descriptors.dtype == torch.int8 else "descriptors")
    assert tree[key].shape == (CAPACITY, idx.dim // 2 if idx.is_int4
                               else idx.dim)
    assert tree[key].dtype == meta["dtypes"][key] == (
        "int8" if key != "descriptors" else idx.cfg.index.dtype)
    back = _load(stream, mesh)
    assert back.placed == (mesh != "none")
    if back.placed:
        assert len(back.placement.shards) == 4
    assert back.dim == idx.dim and back.names == idx.names
    assert torch.equal(back.ids, idx.ids)
    for name in ("descriptors", "scales", "regional", "regional_scales"):
        want, got = getattr(idx, name), _store(back, name)
        assert (want is None) == (got is None), name
        if want is not None:
            assert got.dtype == want.dtype and torch.equal(got, want), name
    for view in ("ivf", "pq", "ivfpq", "lw"):
        assert (getattr(back, view) is None) == (getattr(idx, view) is None)
    _, q, _, qreg = _data()
    if case == "l2":
        q = q * 3.0
    twin = _load(npz, mesh)
    scfgs = [idx.cfg.search]
    if case.endswith("regional"):
        scfgs.append(idx.cfg.search.replace(rerank_enabled=True,
                                            rerank_depth=20))
    if "lw" in case:
        scfgs.append(idx.cfg.search.replace(lw_enabled=True,
                                            rerank_depth=20))
    for scfg in scfgs:
        for route in (True, False):
            s = scfg.replace(use_pallas=route)
            a = back.with_search(use_pallas=route).search(
                q, s, query_regional=qreg if s.rerank_enabled else None)
            b = twin.with_search(use_pallas=route).search(
                q, s, query_regional=qreg if s.rerank_enabled else None)
            for u, v in zip(a, b):
                np.testing.assert_array_equal(u, v)


@pytest.fixture(scope="module")
def cutoff_saves(tmp_path_factory):
    """The three cutoff cases saved with ``streaming=None`` by both
    packages: case -> (the JAX form, the port's form)."""
    tmp = tmp_path_factory.mktemp("cutoff")
    rng = np.random.default_rng(3)
    out = {}
    # bf16 at D = 64: 128 bytes a row and 4 of its id; 8 MiB is 63,550.2
    # rows, so 63,488 rows stay under the cutoff and 63,560 reach it
    for case, n, regions in (("under", 63_488, 0), ("over", 63_560, 0),
                             ("regional", 64, 1025)):
        x = _unit(rng, (n, 64))
        icfg = dict(dtype="bfloat16", row_tile=8)
        jidx = JaxIndex.from_descriptors(
            x, [f"r{i}" for i in range(n)],
            JaxPipelineConfig(index=JaxIndexConfig(**icfg)))
        tidx = Index.from_descriptors(
            x, [f"r{i}" for i in range(n)],
            PipelineConfig(index=IndexConfig(**icfg)), device="cpu")
        if regions:
            reg = _unit(rng, (n, regions, 64))
            jax_attach(jidx, reg)
            attach_regional_store(tidx, reg)
        assert tidx.n_pad == jidx.descriptors.shape[0] == n
        forms = []
        for side, idx in (("jax", jidx), ("port", tidx)):
            path = str(tmp / f"{case}_{side}")
            idx.save(path)
            forms.append(json.load(open(os.path.join(path,
                                                     "meta.json")))["format"])
            shutil.rmtree(path)
        out[case] = tuple(forms)
    return out


@pytest.mark.parametrize("case,streams", [("under", False), ("over", True),
                                          ("regional", True)])
def test_streaming_none_chooses_as_the_reference(cutoff_saves, case,
                                                 streams):
    jax_form, port_form = cutoff_saves[case]
    assert jax_form == ("orbax" if streams else "npz")
    assert port_form == (Index.STREAM_FORMAT if streams else "npz")


class _Spy:
    """A memory map that logs the elements of each read or write."""

    def __init__(self, mm, name, log):
        self.mm, self.name, self.log = mm, name, log

    shape = property(lambda self: self.mm.shape)
    dtype = property(lambda self: self.mm.dtype)

    def _count(self, key):
        return np.empty(self.mm.shape, np.bool_)[key].size

    def __getitem__(self, key):
        self.log.append(("read", self.name, self._count(key)))
        return self.mm[key]

    def __setitem__(self, key, value):
        self.log.append(("write", self.name, self._count(key)))
        self.mm[key] = value

    def flush(self):
        self.mm.flush()


@pytest.mark.parametrize("case", ["int8_regional", "int4",
                                  "bfloat16_regional"])
def test_placed_load_and_save_touch_one_shard_at_a_time(saved, case,
                                                        tmp_path,
                                                        monkeypatch):
    _, stream, _ = saved[case]
    log = []
    real = checkpoint._memmap

    def spy(path, mode, region=None):
        name = os.path.basename(path)[:-len(".npy")]
        return _Spy(real(path, mode, region), name, log)

    monkeypatch.setattr(checkpoint, "_memmap", spy)
    tree = checkpoint.open_tree(os.path.join(stream, "store"))
    shard = {k: int(np.prod(leaf.shape)) // 4 for k, leaf in tree.items()
             if k in STORE_NAMES}
    placed = Index.load(stream, mesh=make_mesh(4, devices=["cpu"] * 4))
    reads = [(n, c) for op, n, c in log if op == "read" and n in shard]
    assert {n for n, _ in reads} == set(shard)
    assert all(c <= shard[n] for n, c in reads), reads
    log.clear()
    placed.save(str(tmp_path / "again"), streaming=True)
    writes = [(n, c) for op, n, c in log if op == "write" and n in shard]
    assert {n for n, _ in writes} == set(shard)
    assert all(c <= shard[n] for n, c in writes), writes
    assert len(writes) == 4 * len(shard)
    monkeypatch.undo()
    again = Index.load(str(tmp_path / "again"), device="cpu")
    for name in ("descriptors", "scales", "regional", "regional_scales"):
        want = getattr(saved[case][0], name)
        if want is not None:
            assert torch.equal(getattr(again, name), want), name


@pytest.mark.parametrize("breakage", ["missing", "short", "reshaped"])
def test_broken_stream_raises(saved, breakage, tmp_path):
    _, stream, npz = saved["int8_regional"]
    path = str(tmp_path / "broken")
    shutil.copytree(stream, path)
    shutil.copyfile(os.path.join(npz, "index.npz"),
                    os.path.join(path, "index.npz"))
    leaf = os.path.join(path, "store", "descriptors_int8.npy")
    if breakage == "missing":
        os.remove(leaf)
    elif breakage == "short":
        data = open(leaf, "rb").read()
        with open(leaf, "wb") as f:
            f.write(data[:len(data) // 2])
    else:
        np.save(leaf, np.zeros((CAPACITY - 8, D), np.int8))
    err = FileNotFoundError if breakage == "missing" else ValueError
    for mesh in (None, make_mesh(4, devices=["cpu"] * 4)):
        with pytest.raises(err):
            Index.load(path, device="cpu", mesh=mesh)
