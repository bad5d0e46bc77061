#!/usr/bin/env python3
"""Which ``torch.distributed`` backends let two processes on ONE card run
the collectives the port's multi-process model-parallel routes use
(``parallel/tp.py``, ``pp.py``, ``sp.py``, ``extractor.py``) on CUDA
tensors.

    python3 tools/cuda_group_probe.py [--timeout 120]

Starts two processes on ``cuda:0`` for each backend (gloo, NCCL), joined
over the loopback, and in each runs on CUDA tensors: ``all_reduce`` (f32
and bf16), ``all_gather``, ``all_to_all``, ``broadcast``,
``isend``/``irecv`` and an ``all_reduce`` over a ``new_group`` subgroup,
each checked against its known answer. Prints one JSON line a backend:
``{"backend": ..., "init": "ok" | error, "ops": {op: "ok" | error}}`` with
the card's ``nvidia-smi`` name and power limit first. A process that does
not finish within ``--timeout`` seconds is killed and reported as such.
Needs one CUDA card; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys


def _ops(dist, torch, rank: int) -> dict:
    """Every probed collective on ``cuda:0``: op -> "ok" or its error."""
    dev = torch.device("cuda:0")
    res = {}

    def probe(name, fn):
        try:
            fn()
            torch.cuda.synchronize()
            res[name] = "ok"
        except Exception as e:        # report every failure, go on
            res[name] = f"{type(e).__name__}: {str(e)[:300]}"

    def all_reduce(dtype):
        t = torch.full((1024,), rank + 1.0, device=dev, dtype=dtype)
        dist.all_reduce(t)
        if not bool((t == 3).all()):
            raise AssertionError(f"sum {t[0].item()}")

    def all_gather():
        t = torch.full((4, 8), float(rank), device=dev)
        out = [torch.empty_like(t) for _ in range(2)]
        dist.all_gather(out, t)
        if not all(bool((o == r).all()) for r, o in enumerate(out)):
            raise AssertionError("wrong parts")

    def all_to_all():
        ins = [torch.full((3, 5), 10.0 * rank + j, device=dev)
               for j in range(2)]
        outs = [torch.empty(3, 5, device=dev) for _ in range(2)]
        dist.all_to_all(outs, ins)
        if not all(bool((o == 10 * j + rank).all())
                   for j, o in enumerate(outs)):
            raise AssertionError("wrong parts")

    def broadcast():
        t = torch.full((16,), 7.0 if rank == 1 else 0.0, device=dev)
        dist.broadcast(t, src=1)
        if not bool((t == 7).all()):
            raise AssertionError("not broadcast")

    def send_recv():
        if rank == 0:
            dist.isend(torch.arange(64.0, device=dev), dst=1).wait()
        else:
            t = torch.empty(64, device=dev)
            dist.irecv(t, src=0).wait()
            if not torch.equal(t, torch.arange(64.0, device=dev)):
                raise AssertionError("wrong payload")

    def subgroup():
        g = dist.new_group([0, 1])
        t = torch.ones(32, device=dev)
        dist.all_reduce(t, group=g)
        if not bool((t == 2).all()):
            raise AssertionError("wrong sum")

    probe("all_reduce_f32", lambda: all_reduce(torch.float32))
    probe("all_reduce_bf16", lambda: all_reduce(torch.bfloat16))
    probe("all_gather", all_gather)
    probe("all_to_all", all_to_all)
    probe("broadcast", broadcast)
    probe("isend_irecv", send_recv)
    probe("new_group_all_reduce", subgroup)
    return res


def worker(backend: str, rank: int, port: int) -> None:
    import datetime

    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    out = {"backend": backend, "rank": rank}
    try:
        dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:"
                                f"{port}", rank=rank, world_size=2,
                                timeout=datetime.timedelta(seconds=60))
        out["init"] = "ok"
    except Exception as e:
        out["init"] = f"{type(e).__name__}: {str(e)[:300]}"
        print(json.dumps(out), flush=True)
        return
    out["ops"] = _ops(dist, torch, rank)
    print(json.dumps(out), flush=True)
    dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--timeout", type=float, default=120.0)
    ap.add_argument("--worker", nargs=3, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(args.worker[0], int(args.worker[1]), int(args.worker[2]))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)
    env = dict(os.environ, NCCL_SOCKET_IFNAME="lo", GLOO_SOCKET_IFNAME="lo")
    for backend in ("gloo", "nccl"):
        port = _free_port()
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--worker", backend,
             str(r), str(port)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, env=env) for r in range(2)]
        lines = {}
        for r, p in enumerate(procs):
            try:
                text = p.communicate(timeout=args.timeout)[0]
            except subprocess.TimeoutExpired:
                p.kill()
                text = p.communicate()[0] + "\nkilled at the timeout"
            lines[r] = text
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        reports = []
        for r in range(2):
            found = [json.loads(s) for s in lines[r].splitlines()
                     if s.startswith("{")]
            reports.append(found[-1] if found else
                           {"backend": backend, "rank": r,
                            "init": lines[r][-600:]})
        print(json.dumps({"backend": backend, "ranks": reports}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
