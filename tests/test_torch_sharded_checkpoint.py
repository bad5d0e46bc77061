"""``utils/checkpoint.py``'s sharded tree (``save_sharded_pytree`` /
``load_sharded_pytree``, the port of the reference's orbax pair) on CPU
meshes, in one process and across two.

One process: trees of bf16, f32, int8 and int32 leaves, placed along dim 0
or 1 over ``["cpu"] * S`` (S = 1, 2, 4) or whole, written and read back
placed on another shard count or whole: every part equals its rows of the
saved tensor bit for bit, bf16 is written as its ``uint16`` bits and
recorded as ``bfloat16``; the files equal a whole-tensor save's whatever
the shard count; a missing, short or mis-shaped leaf file raises.

Two processes (tests/torch_ckpt_worker.py, which imports no JAX; gloo over
the loopback, 2 CPU shards each): each writes its own rows of one tree and
reads them back placed, then saves a placed index as the port's stream and
loads it placed. The tree's and the stream's files must be byte-equal to
the single-process saves, and the parts and answers equal.
"""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_ckpt_worker as worker
from instsearch_torch.index import Index
from instsearch_torch.parallel import make_mesh, make_mesh_2d, shard_rows
from instsearch_torch.utils.checkpoint import (TREE_FILE, Placed,
                                               load_sharded_pytree,
                                               open_tree, save_sharded_pytree)

WORLD = 2
DTYPES = (torch.bfloat16, torch.float32, torch.int8, torch.int32)


def _mesh(n):
    return make_mesh(n, devices=["cpu"] * n)


def _leaf(dtype, shape, seed=0):
    g = torch.Generator().manual_seed(seed)
    if dtype.is_floating_point:
        return torch.randn(*shape, generator=g).to(dtype)
    return torch.randint(-100, 100, shape, generator=g).to(dtype)


def _files(path) -> dict:
    return {f: open(os.path.join(path, f), "rb").read()
            for f in sorted(os.listdir(path))}


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shards,dim", [(1, 0), (2, 0), (4, 0), (4, 1)])
def test_placed_round_trip(tmp_path, dtype, shards, dim):
    shape = (16, 6) if dim == 0 else (3, 16)
    t = _leaf(dtype, shape)
    mesh = _mesh(shards)
    save_sharded_pytree(str(tmp_path / "p"), {
        "t": Placed(shard_rows(mesh, t, dim=dim), dim, mesh)})
    save_sharded_pytree(str(tmp_path / "w"), {"t": t})
    assert _files(tmp_path / "p") == _files(tmp_path / "w")
    rec = json.load(open(tmp_path / "p" / TREE_FILE))["leaves"]["t"]
    assert rec["shape"] == list(shape)
    assert rec["dtype"] == str(dtype).split(".")[-1]
    raw = np.load(tmp_path / "p" / "t.npy")
    assert raw.dtype == (np.uint16 if dtype == torch.bfloat16
                         else t.numpy().dtype)
    for n in (1, 2, 4, 8):
        back = load_sharded_pytree(str(tmp_path / "p"),
                                   {"t": (_mesh(n), dim)})["t"]
        assert len(back) == n
        for j, part in enumerate(back):
            want = t.narrow(dim, j * shape[dim] // n, shape[dim] // n)
            assert part.dtype == dtype and torch.equal(part, want)
    whole = load_sharded_pytree(str(tmp_path / "p"))["t"]
    assert whole.device.type == "cpu" and torch.equal(whole, t)


def test_mixed_tree_and_a_2d_mesh_axis(tmp_path):
    """Placed leaves along different dims beside whole ones (a 0-d leaf
    too), read back over a 2-D mesh's ``'shard'`` axis."""
    mesh = _mesh(4)
    x = _leaf(torch.bfloat16, (8, 5), 1)
    s = _leaf(torch.float32, (1, 8), 2)
    tree = {"x": Placed(shard_rows(mesh, x), 0, mesh),
            "s": Placed(shard_rows(mesh, s, dim=1), 1, mesh),
            "ids": torch.arange(8, dtype=torch.int32),
            "scalar": torch.tensor(2.5)}
    save_sharded_pytree(str(tmp_path), tree)
    axis = make_mesh_2d(2, 2, devices=["cpu"] * 4).along("shard")
    back = load_sharded_pytree(str(tmp_path), {"x": (axis, 0),
                                               "s": (axis, 1)})
    assert torch.equal(torch.cat(back["x"]), x)
    assert torch.equal(torch.cat(back["s"], 1), s)
    assert torch.equal(back["ids"], tree["ids"])
    assert back["scalar"].item() == 2.5
    assert set(open_tree(str(tmp_path))) == set(tree)


def test_broken_trees_raise(tmp_path):
    t = _leaf(torch.float32, (16, 4))
    path = str(tmp_path / "t")
    save_sharded_pytree(path, {"t": t, "u": t[:, :2]})
    leaf = os.path.join(path, "t.npy")
    data = open(leaf, "rb").read()
    with open(leaf, "wb") as f:          # a short file
        f.write(data[:-16])
    with pytest.raises(ValueError):
        open_tree(path)
    np.save(leaf, np.zeros((15, 4), np.float32))   # another shape
    with pytest.raises(ValueError, match="records"):
        load_sharded_pytree(path)
    os.remove(leaf)                      # a missing leaf
    with pytest.raises(FileNotFoundError, match="missing"):
        open_tree(path)
    os.remove(os.path.join(path, TREE_FILE))      # an unfinished save
    with pytest.raises(FileNotFoundError, match=TREE_FILE):
        load_sharded_pytree(path)
    save_sharded_pytree(path, {"t": t})
    with pytest.raises(ValueError, match="divide"):
        load_sharded_pytree(path, {"t": (_mesh(3), 0)})


@pytest.fixture(scope="module")
def two_processes(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_ckpt")
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
        assert p.returncode == 0 and f"CKPT_OK {r}" in log, \
            f"worker {r} failed:\n{log[-3000:]}"
    return out, [dict(np.load(out / f"rank{r}.npz")) for r in range(WORLD)]


def test_two_processes_write_one_tree(two_processes, tmp_path):
    out, ranks = two_processes
    x, s, w = worker.make_tree()
    mesh = _mesh(WORLD * worker.LOCAL_SHARDS)
    save_sharded_pytree(str(tmp_path), {
        "x": Placed(shard_rows(mesh, x), 0, mesh),
        "s": Placed(shard_rows(mesh, s, dim=1), 1, mesh), "w": w})
    assert _files(out / "tree") == _files(tmp_path)
    c = worker.ROWS // (WORLD * worker.LOCAL_SHARDS)
    for r, res in enumerate(ranks):
        for j in range(worker.LOCAL_SHARDS):
            g = r * worker.LOCAL_SHARDS + j
            np.testing.assert_array_equal(
                res[f"tree_x{j}"], x[g * c:(g + 1) * c].float().numpy())
            np.testing.assert_array_equal(
                res[f"tree_s{j}"], s[:, g * c:(g + 1) * c].numpy())


def test_two_processes_stream_an_index(two_processes, tmp_path):
    out, ranks = two_processes
    idx, q = worker.make_index()
    idx.save(str(tmp_path), streaming=True)
    assert _files(out / "stream" / "store") == _files(tmp_path / "store")
    mine = json.load(open(tmp_path / "meta.json"))
    theirs = json.load(open(out / "stream" / "meta.json"))
    assert mine == theirs and mine["format"] == Index.STREAM_FORMAT
    c = worker.CAPACITY // (WORLD * worker.LOCAL_SHARDS)
    ws, wi = idx.search(q)
    for r, res in enumerate(ranks):
        for j in range(worker.LOCAL_SHARDS):
            g = r * worker.LOCAL_SHARDS + j
            np.testing.assert_array_equal(
                res[f"index_x{j}"], idx.descriptors[g * c:(g + 1) * c])
        np.testing.assert_array_equal(res["search_i"], wi)
        np.testing.assert_array_equal(res["search_s"], ws)
