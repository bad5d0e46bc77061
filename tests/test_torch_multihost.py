"""The port's multi-process sharded index: two processes of four CPU shards
each, joined by gloo over the loopback (``torch.distributed``), as
tests/distributed/test_multihost.py runs JAX. Each worker
(tests/torch_mh_worker.py, which imports no JAX) hands
``build_multihost_index`` only its own rows; ``search``, ``search_qe``,
``full_ranking`` and ``search_rerank`` over bf16 and int8 stores (kernel
route: the kernels' plain versions on the CPU) must equal, on both
processes, the single-process port's ``Index`` over the same rows: ids and
scores equal. One spawn serves the module.
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

import torch_mh_worker as worker

WORLD = 2


@pytest.fixture(scope="module")
def answers(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_mh")
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
        assert p.returncode == 0 and f"MH_OK {r}" in log, \
            f"worker {r} failed:\n{log[-3000:]}"
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(WORLD)]


@pytest.fixture(scope="module")
def single():
    """The single-process port over the same rows, per store dtype."""
    _, q, _, qreg = worker.make_data()
    res = {}
    for dtype in ("bfloat16", "int8"):
        idx = worker.make_index(dtype)
        scfg = idx.cfg.search
        for name, (s, i) in (
                ("search", idx.search(q)),
                ("qe", idx.search(q, scfg.replace(qe_enabled=True,
                                                  qe_n=worker.QE_N))),
                ("rerank", idx.search(q, scfg.replace(
                    rerank_enabled=True, rerank_depth=worker.DEPTH),
                    query_regional=qreg))):
            res[f"{dtype}_{name}_s"], res[f"{dtype}_{name}_i"] = s, i
        res[f"{dtype}_ranking"] = idx.full_ranking(q)
    return res


@pytest.mark.parametrize("what", ["search", "qe", "rerank"])
@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_two_processes_equal_one(answers, single, dtype, what):
    for res in answers:
        np.testing.assert_array_equal(res[f"{dtype}_{what}_i"],
                                      single[f"{dtype}_{what}_i"])
        np.testing.assert_array_equal(res[f"{dtype}_{what}_s"],
                                      single[f"{dtype}_{what}_s"])


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_two_processes_full_ranking(answers, single, dtype):
    for res in answers:
        assert res[f"{dtype}_ranking"].shape == (7, worker.N)
        np.testing.assert_array_equal(res[f"{dtype}_ranking"],
                                      single[f"{dtype}_ranking"])


def test_initialize_is_a_no_op_in_one_process(monkeypatch):
    """Without ``WORLD_SIZE`` no group starts and the mesh holds none; a
    world named without its address raises rather than guess one."""
    from instsearch_torch.parallel import (global_shard_mesh, initialize,
                                           local_row_range)
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    assert initialize() is False
    mesh = global_shard_mesh(["cpu"] * 4)
    assert mesh.group is None and mesh.num_shards == 4 and mesh.rank == 0
    assert local_row_range(256) == (0, 256)
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(RuntimeError, match="MASTER_ADDR"):
        initialize()
    import torch.distributed as dist
    if not dist.is_nccl_available():        # a CPU build of PyTorch
        monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
        monkeypatch.setenv("MASTER_PORT", "1")
        with pytest.raises(RuntimeError, match="not available"):
            initialize(backend="nccl")


@pytest.mark.parametrize("dtype,kernel", [("bfloat16", "topk_matmul"),
                                          ("int8", "topk_matmul_int8")])
def test_multihost_index_defaults_to_the_kernels(monkeypatch, dtype, kernel):
    """``build_multihost_index`` without ``use_pallas`` takes the kernel
    route, as ``SearchConfig`` does: each shard calls its store's kernel
    wrapper (on a CPU shard the plain version behind it), never the scoring
    oracle, and answers as the single-process ``Index``."""
    import instsearch_torch.parallel.sharded_index as si
    from instsearch_torch.parallel import (build_multihost_index,
                                           global_shard_mesh)
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    idx = worker.make_index(dtype)
    sidx = build_multihost_index(
        idx.descriptors, idx.ids.numpy(),
        mesh=global_shard_mesh(["cpu"] * worker.LOCAL_SHARDS),
        local_scales=idx.scales, k=worker.K)
    assert sidx.use_pallas is True
    calls = []
    wrapper = getattr(si, kernel)

    def counted(*args, **kwargs):
        calls.append(kwargs["num_valid"])
        return wrapper(*args, **kwargs)

    def no_oracle(*args, **kwargs):
        raise AssertionError("the sharded search took the scoring oracle")

    monkeypatch.setattr(si, kernel, counted)
    monkeypatch.setattr(si, "search_topk", no_oracle)
    _, q, _, _ = worker.make_data()
    s, i = sidx.search(q)
    assert calls == [sh.num_valid for sh in sidx.shards]
    want_s, want_i = idx.search(q)
    np.testing.assert_array_equal(i.numpy(), want_i)
    np.testing.assert_array_equal(s.numpy(), want_s)
