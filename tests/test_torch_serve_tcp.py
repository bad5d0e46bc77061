"""The port's TCP transport (``instsearch_torch/serve.py::serve_tcp``) over
loopback, mirroring tests/integration/test_serve_tcp.py for the reference:
a query round trip with error lines on a live connection, cross-client
micro-batching, mutations as barriers, and the subset ``batch_key``
keeping requests under different subsets out of one device batch.

The server runs in-process on an ephemeral port over an index loaded from
a saved build (the mini fixture, ResNet-18 at 64 px, f32); a twin loaded
from the same files answers every request through
``ServeCore.handle_line`` on the test's thread, and gets every mutation
the server gets. Each TCP response equals the twin's key for key (but
``latency_ms``, and ``batch_rows``, which says how many rows shared the
device batch): ids, names, ranks, counts and error lines equal; scores
equal where the request ran alone at its own bucket size, within 1e-5 of
the largest where it was co-batched (the backbone ran at another batch
size)."""
import json
import socket
import threading

import pytest
import torch

from instsearch_torch import (ExtractConfig, IndexConfig, PipelineConfig,
                              SearchConfig)
from instsearch_torch.eval import make_mini_dataset
from instsearch_torch.index import Index
from instsearch_torch.serve import ServeCore, serve_tcp

CFG = PipelineConfig(
    extract=ExtractConfig(backbone="resnet18", pooling="gem", image_size=64,
                          batch_size=8, dtype="float32"),
    index=IndexConfig(dtype="float32", row_tile=8),
    search=SearchConfig(k=5))
CO_BATCHED_TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """The suite runs in several worker processes on a few cores: this
    module's small CPU tensors take one intra-op thread (no oversubscribed
    thread pools), restored afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve_tcp")
    mini = make_mini_dataset(str(tmp / "mini"), seed=21)
    Index.build(mini.db_paths, CFG, seed=0, device="cpu").save(
        str(tmp / "idx"))
    return mini, str(tmp / "idx")


@pytest.fixture()
def tcp_server(saved):
    """serve_tcp on an ephemeral port -> (mini, connect, twin core)."""
    mini, path = saved
    core = ServeCore(Index.load(path, device="cpu"))
    twin = ServeCore(Index.load(path, device="cpu"))
    stop = threading.Event()
    port_box: "list[int]" = []
    got_port = threading.Event()

    def ready(p):
        port_box.append(p)
        got_port.set()

    t = threading.Thread(
        target=serve_tcp, daemon=True,
        kwargs=dict(core=core, port=0, batch_wait_ms=150.0,
                    ready_cb=ready, stop_event=stop))
    t.start()
    assert got_port.wait(timeout=120), "server never came up"
    conns = []

    def connect():
        s = socket.create_connection(("127.0.0.1", port_box[0]), timeout=60)
        f = s.makefile("rw")
        conns.append((s, f))
        return f

    yield mini, connect, twin
    stop.set()
    for s, _ in conns:
        s.close()
    t.join(timeout=10)
    assert not t.is_alive()


def _send(f, req) -> dict:
    f.write((req if isinstance(req, str) else json.dumps(req)) + "\n")
    f.flush()
    return json.loads(f.readline())


def _agree(got: dict, want: dict, co_batched: bool = False) -> None:
    assert set(got) == set(want), (got, want)
    if "error" in want:
        assert got == want
        return
    for key in set(want) - {"latency_ms", "batch_rows", "results"}:
        assert got[key] == want[key], key
    if "results" not in want:
        return
    assert len(got["results"]) == len(want["results"])
    for grow, wrow in zip(got["results"], want["results"]):
        assert [(e["rank"], e["name"], e["id"]) for e in grow] == \
            [(e["rank"], e["name"], e["id"]) for e in wrow]
        for a, b in zip(grow, wrow):
            if co_batched:
                assert abs(a["score"] - b["score"]) <= CO_BATCHED_TOL
            else:
                assert a["score"] == b["score"]


def _ask(f, twin, req, co_batched: bool = False) -> dict:
    got = _send(f, req)
    _agree(got, twin.handle_line(
        req if isinstance(req, str) else json.dumps(req)), co_batched)
    return got


def test_tcp_query_roundtrip(tcp_server):
    mini, connect, twin = tcp_server
    f = connect()
    r = _ask(f, twin, {"image": mini.db_paths[0], "k": 3})
    assert r["results"][0][0]["name"] == mini.imlist[0]
    assert len(r["results"][0]) == 3
    assert r["latency_ms"] > 0 and r["batch_rows"] == 1
    # errors answer on the same connection, which stays usable
    assert "error" in _ask(f, twin, {"image": "/nonexistent.jpg"})
    assert "error" in _ask(f, twin, "not json")
    assert "error" in _send(f, [1, 2])          # a non-object request
    r = _ask(f, twin, {"images": mini.db_paths[1:4]})
    assert [row[0]["name"] for row in r["results"]] == mini.imlist[1:4]
    # k beyond the rows: strict JSON, padded slots dropped
    f.write(json.dumps({"image": mini.db_paths[0], "k": 80}) + "\n")
    f.flush()
    line = f.readline()
    assert "Infinity" not in line
    assert all(e["id"] >= 0 for e in json.loads(line)["results"][0])


def _fire(files, reqs):
    out: "list[dict]" = [None] * len(files)
    barrier = threading.Barrier(len(files))

    def go(i):
        barrier.wait()
        out[i] = _send(files[i], reqs[i])

    threads = [threading.Thread(target=go, args=(i,))
               for i in range(len(files))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    return out


def test_tcp_cross_client_microbatching(tcp_server):
    """Concurrent queries from separate connections within the batching
    window run as ONE device batch (batch_rows > 1)."""
    mini, connect, twin = tcp_server
    files = [connect() for _ in range(3)]
    for i, f in enumerate(files):          # the connection threads exist
        _ask(f, twin, {"image": mini.db_paths[i], "k": 1})
    reqs = [{"image": mini.db_paths[i], "k": 2} for i in range(3)]
    out = _fire(files, reqs)
    for i, r in enumerate(out):
        assert r["results"][0][0]["name"] == mini.imlist[i]
        _agree(r, twin.handle_line(json.dumps(reqs[i])), co_batched=True)
    # the 150 ms window is far wider than the fire skew
    assert max(r["batch_rows"] for r in out) >= 2


def test_tcp_mutation_barrier(tcp_server):
    """remove -> query on one connection: the mutation is a dispatcher
    barrier, so the following query sees the mutated corpus."""
    mini, connect, twin = tcp_server
    f = connect()
    victim = mini.imlist[4]
    assert _ask(f, twin, {"remove": [victim]})["removed"] == 1
    r = _ask(f, twin, {"image": mini.db_paths[4], "k": 5})
    assert all(e["name"] != victim for e in r["results"][0])
    # a failing mutation answers an error line; the server keeps serving
    assert "error" in _ask(f, twin, {"remove": ["no-such-name"]})
    qpath = mini.image_path(mini.qimlist[0])
    assert _ask(f, twin, {"add": [qpath]})["added"] == 1
    r = _ask(f, twin, {"image": qpath, "k": 1})
    assert r["results"][0][0]["name"] == mini.qimlist[0]


def test_tcp_subset_batch_key_separation(tcp_server):
    """Requests under different subsets never share a device batch (one
    mask per batch): each answer holds its own subset's members only."""
    mini, connect, twin = tcp_server
    f = connect()
    members = {"a": mini.imlist[0:12:2], "b": mini.imlist[1:12:2]}
    for name, names in members.items():
        r = _ask(f, twin, {"define_subset": {"name": name,
                                             "members": names}})
        assert r["count"] == len(names)
    files = [connect() for _ in range(4)]
    for g in files:
        _ask(g, twin, {"image": mini.db_paths[0], "k": 1})
    subsets = ["a", "b", "a", "b"]
    reqs = [{"image": mini.db_paths[i], "k": 3, "subset": s}
            for i, s in enumerate(subsets)]
    out = _fire(files, reqs)
    for req, r in zip(reqs, out):
        assert {e["name"] for e in r["results"][0]} <= \
            set(members[req["subset"]])
        assert r["batch_rows"] <= 2
        _agree(r, twin.handle_line(json.dumps(req)), co_batched=True)
    assert "error" in _ask(f, twin, {"image": mini.db_paths[0],
                                     "subset": "nope"})
