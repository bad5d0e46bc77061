"""Serving: bucketed request handling over JSON lines (port of
``instsearch_tpu/serve.py``: ``serve_buckets``, ``serve_batch``,
``ServeCore``, on one device or through the sharded index,
``VectorServeCore``, raw vectors over a host row store and an IVF-PQ view,
and ``serve_tcp``, the TCP transport with cross-client micro-batching).

Requests, one JSON object a line, answered key for key as the reference
answers them:

  * ``{"image": PATH}`` or ``{"images": [PATH, ...]}``, optional ``"k"`` and
    ``"subset": NAME`` (a registered subset) -> ``{"results", ...}``;
  * ``{"define_subset": {"name": N, "members": [names]}}``,
    ``{"drop_subset": N}`` -> the subsets defined;
  * ``{"add": [PATH, ...]}``, ``{"remove": [names]}`` -> rows added or
    removed; registered subsets are rebuilt from their surviving members'
    names, and the sharded index is cut again from the mutated store;
  * ``{"range": {"image": P, "tau": T[, "max_results": M][, "subset":
    N]}}`` -> every row scoring at least ``tau`` and their exact count
    (``Index.search_range``, on one device);
  * ``{"reconstruct": {"names": [...]} | {"ids": [...]}}`` -> the stored
    rows.

A bad request never raises out of ``handle_line``: it is answered with an
``{"error": ...}`` line.

``VectorServeCore`` answers ``{"vector": [...]}`` / ``{"vectors": [[...],
...]}`` requests (optional ``"k"``, ``"subset"``) from a ``HostRowStore``
and an ``IVFPQView`` (``search/ivfpq.py``): the capacity deployment, the
exact rows in a host file and only the codes on the card. Subsets are
defined by store ids or positions; ``add``/``remove`` are refused.

The bucket policy is kept as the reference has it: requests run through
batch sizes 1, 2, 4, 8 (split or padded up), which a later CUDA-graph
capture needs as its fixed shapes. Nothing compiles per shape in eager
PyTorch, so defining a subset needs no warm pass.

Two transports share a core: the caller's loop over stdin lines
(``handle_line``, ``cli serve``) and ``serve_tcp`` (``cli serve --port``):
many concurrent JSON-lines connections whose query requests, arriving
within ``batch_wait_ms`` of each other, run as ONE device batch through the
bucket shapes (responses carry ``batch_rows``). Threading contract, the
reference's: connection threads only parse JSON and decode images (host
work); one dispatcher thread does all device work, so no two CUDA
sequences interleave; mutations (``add``/``remove``/subset definitions)
are barriers that end the batch being filled, so global queue order holds
(a client that sends ``remove`` then a query sees its mutation applied);
a batch takes one subset mask, so only requests with the same ``subset``
share one; a failing request is answered with an error line and never
stops the server.
"""
from __future__ import annotations

import json
import queue
import socket
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from .utils.observe import COUNTERS


def serve_buckets(query_chunk: int) -> list[int]:
    """Warm bucket sizes: powers of two up to min(8, query_chunk)."""
    buckets = [1]
    while buckets[-1] < min(8, max(1, query_chunk or 8)):
        buckets.append(buckets[-1] * 2)
    return buckets


def serve_batch(idx, sidx, batch: np.ndarray, scfg, buckets, subset=None):
    """Serve an image batch of any size through the bucket shapes only:
    larger requests split into largest-bucket pieces, the remainder padded
    up to the smallest covering bucket (padding rows are dropped).
    ``sidx``: the sharded index to search through, or None; ``subset``: a
    ``SubsetFilter`` restricting the results."""
    n = batch.shape[0]
    out_s, out_i = [], []
    pos = 0
    while pos < n:
        rem = n - pos
        b = next((x for x in buckets if x >= rem), buckets[-1])
        take = min(rem, b)
        piece = batch[pos:pos + take]
        if take < b:
            piece = np.concatenate(
                [piece, np.repeat(piece[-1:], b - take, axis=0)])
        s, i = idx.query_images(piece, scfg, sharded_index=sidx,
                                subset=subset)
        out_s.append(s[:take])
        out_i.append(i[:take])
        pos += take
    return np.concatenate(out_s), np.concatenate(out_i)


def _is_mutation(req: dict) -> bool:
    return ("add" in req or "remove" in req or "define_subset" in req
            or "drop_subset" in req)


@dataclass
class _Job:
    kind: str                        # "query" | "mutate"
    req: dict
    images: Optional[np.ndarray]     # decoded [B, S, S, 3] uint8 (query)
    reply: Callable[[dict], None]
    enqueued: float = field(default_factory=time.perf_counter)

    @property
    def batch_key(self):
        """Jobs share a device batch only under the same subset filter: the
        mask is one operand per batch, not per query."""
        return self.req.get("subset")


class ServeCore:
    """Owns the index, the optional sharded view (``idx.to_sharded(mesh)``
    when ``sharded``), its warm bucket shapes and the named subsets.
    ``decode`` is host-only; ``mutate`` and ``run_queries`` touch the
    device and stay on one thread."""

    def __init__(self, idx, sharded: bool = False, spill_reserve: int = 4096,
                 *, mesh=None):
        self.idx = idx
        self.mesh = mesh
        self.sidx = idx.to_sharded(mesh=mesh) if sharded else None
        # the attached IVF / IVF-PQ views' spill arrays grow to hold that
        # many absorbed rows, as the reference's ServeCore grows them (there
        # to keep its compiled shapes; here the arrays are the views' state)
        if spill_reserve:
            if idx.ivf is not None:
                idx.ivf.reserve_spill(spill_reserve, idx)
            if idx.ivfpq is not None:
                idx.ivfpq.reserve_spill(spill_reserve)
        self.size = idx.cfg.extract.image_size
        self.warm_k = idx.cfg.search.k
        self.buckets = serve_buckets(idx.cfg.search.query_chunk)
        # named subset filters, defined by clients and referenced per
        # query; kept by member names so that mutations can rebuild them
        self.subsets: dict = {}

    def query_cap(self) -> int:
        """Micro-batch row cap for the TCP dispatcher."""
        return self.idx.cfg.search.query_chunk or 128

    def warmup(self) -> None:
        """One pass per bucket shape (cuDNN picks its algorithms and the
        kernels load on first use)."""
        for b in self.buckets:
            self.idx.query_images(
                np.zeros((b, self.size, self.size, 3), np.uint8),
                sharded_index=self.sidx)

    def ready_info(self) -> dict:
        ready = {"ready": True, "rows": self.idx.num_valid,
                 "dim": self.idx.dim}
        if self.sidx is not None:
            ready["shards"] = self.sidx.mesh.num_shards
        return ready

    # ---- host side ----------------------------------------------------
    def decode(self, req: dict) -> tuple[np.ndarray, int]:
        """Request -> (decoded image batch, requested k). Raises on
        missing/undecodable paths or a bad k."""
        from .data import frontend
        paths = req.get("images") or [req["image"]]
        imgs = [frontend.load_square(p, self.size) for p in paths]
        bad = [p for p, im in zip(paths, imgs) if im is None]
        if bad:
            raise ValueError(f"cannot decode: {bad}")
        return np.stack(imgs), int(req.get("k", self.warm_k))

    # ---- device side --------------------------------------------------
    def define_subset(self, name: str, members) -> dict:
        """Register a named subset of image names."""
        sub = self.idx.make_subset(names=list(members))
        self.subsets[name] = sub
        return {"subset": name, "count": sub.count,
                "subsets": sorted(self.subsets)}

    def _refresh_subsets(self) -> None:
        """Rebuild the registered subsets a mutation made stale (a remove,
        an add past capacity): the surviving members' names resolve to
        their new positions; removed members drop out."""
        alive = set(self.idx.names)
        for nm, sub in list(self.subsets.items()):
            if (sub.layout_gen == self.idx._layout_gen
                    and sub.n_pad == self.idx.n_pad):
                continue
            members = [m for m in (sub.names or ()) if m in alive]
            self.subsets[nm] = self.idx.make_subset(names=members)

    def mutate(self, req: dict) -> dict:
        """``define_subset``, ``drop_subset``, ``add`` (image paths through
        the index's extractor) or ``remove`` (names); a mutation of the
        store refreshes the subsets and cuts the sharded index again (its
        shards are views with a fixed count of valid rows each). A placed
        index (``Index.load(mesh=)``) is mutated on its shards in place,
        and the sharded index over the placement's mesh is cut again from
        the same parts, nothing copied."""
        t0 = time.perf_counter()
        if "define_subset" in req:
            spec = req["define_subset"]
            resp = self.define_subset(spec["name"], spec["members"])
        elif "drop_subset" in req:
            self.subsets.pop(req["drop_subset"], None)
            resp = {"dropped": req["drop_subset"],
                    "subsets": sorted(self.subsets)}
        elif "add" in req:
            n = self.idx.add(paths=list(req["add"]))
            self._refresh_subsets()
            resp = {"added": n}
        else:
            n = self.idx.remove(list(req["remove"]))
            self._refresh_subsets()
            resp = {"removed": n}
        if self.sidx is not None and ("add" in req or "remove" in req):
            self.sidx = self.idx.to_sharded(mesh=self.mesh)
        resp["rows"] = self.idx.num_valid
        resp["latency_ms"] = round((time.perf_counter() - t0) * 1e3, 3)
        return resp

    def run_queries(self, jobs: "list[tuple[np.ndarray, int]]",
                    subset: "str | None" = None) -> list[dict]:
        """One device pass for a list of (images, req_k) jobs. Runs at the
        warm top-k width unless a request asks for more. ``subset``: the
        name of a registered subset shared by every job."""
        sub = None
        if subset is not None:
            sub = self.subsets.get(subset)
            if sub is None:
                raise KeyError(f"unknown subset {subset!r} — define it "
                               f"first ({{'define_subset': ...}})")
        ks = [k for _, k in jobs]
        k_run = self.warm_k if max(ks) <= self.warm_k else max(ks)
        scfg = self.idx.cfg.search.replace(k=k_run)
        batch = (jobs[0][0] if len(jobs) == 1
                 else np.concatenate([im for im, _ in jobs]))
        t0 = time.perf_counter()
        scores, ids = serve_batch(self.idx, self.sidx, batch, scfg,
                                  self.buckets, subset=sub)
        latency = round((time.perf_counter() - t0) * 1e3, 3)
        out, pos = [], 0
        for images, req_k in jobs:
            b = images.shape[0]
            s, i = scores[pos:pos + b], ids[pos:pos + b]
            pos += b
            # padded slots (id -1 / -inf) are dropped: -inf is not JSON
            results = [[{"rank": r, "name": self.idx.name_of(ii),
                         "id": int(ii), "score": float(ss)}
                        for r, (ss, ii) in enumerate(zip(srow[:req_k],
                                                         irow[:req_k]))
                        if ii >= 0]
                       for srow, irow in zip(s, i)]
            out.append({"results": results, "latency_ms": latency,
                        "batch_rows": int(batch.shape[0])})
        return out

    def handle_line(self, line: str) -> dict:
        """Parse -> decode -> device on the caller's thread. Never raises:
        a long-lived server answers a bad request with an error line."""
        try:
            req = json.loads(line)
            if _is_mutation(req):
                return self.mutate(req)
            if "range" in req:
                spec = req["range"]
                images, _ = self.decode({"image": spec["image"]})
                sub = None
                if spec.get("subset") is not None:
                    sub = self.subsets.get(spec["subset"])
                    if sub is None:
                        raise KeyError(f"unknown subset {spec['subset']!r}")
                s, i, counts = self.idx.search_range(
                    self.idx.extractor(images), float(spec["tau"]),
                    max_results=int(spec.get("max_results", 256)),
                    subset=sub)
                n = int(counts[0])
                results = [{"rank": r, "name": self.idx.name_of(ii),
                            "id": int(ii), "score": float(ss)}
                           for r, (ss, ii) in enumerate(zip(s[0], i[0]))
                           if ii >= 0]
                return {"results": results, "count": n,
                        "truncated": n > len(results)}
            if "reconstruct" in req:
                spec = req["reconstruct"]
                rows = self.idx.reconstruct(names=spec.get("names"),
                                            ids=spec.get("ids"))
                return {"vectors": rows.tolist(), "dim": int(rows.shape[1])}
            images, req_k = self.decode(req)
            return self.run_queries([(images, req_k)],
                                    subset=req.get("subset"))[0]
        except Exception as e:    # noqa: BLE001 — the transport boundary
            return {"error": f"{type(e).__name__}: {e}"}


class VectorServeCore:
    """Capacity vector serving: a ``HostRowStore`` and an ``IVFPQView``
    (``search/ivfpq.py``) answering raw descriptor queries, with no index
    on the device and no extractor. ``device`` is where the view lies and
    the subset masks go (default: the card, raising without one).

      request:  {"vector": [f32 x D]} | {"vectors": [[...], ...]}
                [+ "k": int] [+ "subset": NAME]
                | {"define_subset": {"name": N, "ids": [...]}}
                |                   {... "positions": [...]}}
                | {"drop_subset": N}
      response: {"results": [[{rank, id, score}, ...] per vector], ...}

    ``id`` is the store's id (the row position when it has none).
    Mutations are refused: the store and view are built offline. Two
    modes, fixed at start: the exact host-gather cascade
    (``IVFPQView.search_host``) or ``adc_only`` (``search_adc``: the
    pruned scan's ranking, no host gather)."""

    def __init__(self, store, view, k: int = 10, adc_only: bool = False,
                 query_chunk: int = 128,
                 *, device: "torch.device | str | None" = None):
        from .utils.device import resolve_device
        # "cuda" as the index of the current card, as tensors carry it
        self.device = torch.empty(0, device=resolve_device(device)).device
        if view.device != self.device:
            raise ValueError(f"the view lies on {view.device}, the serving "
                             f"device is {self.device}")
        self.store = store
        self.view = view
        self.warm_k = k
        self.adc_only = adc_only
        self._cap = query_chunk or 128
        self.buckets = serve_buckets(self._cap)
        # named subset filters over store rows, each a [1, N] int8 mask on
        # the device; the corpus is read-only, so they never go stale
        self.subsets: dict = {}
        if view.codebook.dim != store.d:
            raise ValueError(f"view dim {view.codebook.dim} != store "
                             f"dim {store.d}")

    def query_cap(self) -> int:
        return self._cap

    def define_subset(self, name: str, ids=None, positions=None) -> dict:
        """Register a named subset by store ids or row positions."""
        if (ids is None) == (positions is None):
            raise ValueError("define_subset needs exactly one of "
                             "ids= / positions=")
        allow = np.zeros(self.store.n, bool)
        if positions is not None:
            p = np.asarray(list(positions), np.int64)
            if p.size and (p.min() < 0 or p.max() >= self.store.n):
                raise ValueError("subset positions out of range")
            allow[p] = True
        elif self.store.ids is None:       # ids are positions then
            return self.define_subset(name, positions=ids)
        else:
            want = np.asarray(list(ids))
            hit = np.isin(self.store.ids, want)
            if hit.sum() < len(np.unique(want)):
                raise KeyError("some subset ids are not in the store")
            allow = hit
        self.subsets[name] = torch.from_numpy(
            allow[None, :].astype(np.int8)).to(self.device)
        return {"subset": name, "count": int(allow.sum()),
                "subsets": sorted(self.subsets)}

    # ---- host side ----------------------------------------------------
    def decode(self, req: dict) -> tuple[np.ndarray, int]:
        """Request -> (query vectors [B, D] f32, requested k)."""
        vecs = req.get("vectors")
        if vecs is None:
            vecs = [req["vector"]]
        arr = np.asarray(vecs, np.float32)
        if arr.ndim != 2 or arr.shape[1] != self.store.d:
            raise ValueError(
                f"vectors must be [B, {self.store.d}] (got {arr.shape})")
        return arr, int(req.get("k", self.warm_k))

    # ---- device side --------------------------------------------------
    def mutate(self, req: dict) -> dict:
        if "define_subset" in req:
            spec = req["define_subset"]
            return self.define_subset(spec["name"], ids=spec.get("ids"),
                                      positions=spec.get("positions"))
        if "drop_subset" in req:
            self.subsets.pop(req["drop_subset"], None)
            return {"dropped": req["drop_subset"],
                    "subsets": sorted(self.subsets)}
        raise ValueError("host-store serving is read-only; rebuild the "
                         "store/view offline and restart")

    def _search(self, q: np.ndarray, k: int, mask=None):
        if self.adc_only:
            return self.view.search_adc(q, k=k, ids=self.store.ids,
                                        mask=mask)
        return self.view.search_host(self.store, q, k=k, mask=mask)

    def warmup(self) -> None:
        for b in self.buckets:
            self._search(np.zeros((b, self.store.d), np.float32),
                         self.warm_k)

    def ready_info(self) -> dict:
        return {"ready": True, "rows": self.store.n, "dim": self.store.d,
                "mode": "adc" if self.adc_only else "cascade",
                "nprobe": self.view.nprobe, "depth": self.view.depth}

    def run_queries(self, jobs: "list[tuple[np.ndarray, int]]",
                    subset: "str | None" = None) -> list[dict]:
        """One device pass for a list of (vectors, req_k) jobs, padded with
        zero rows up to the smallest covering bucket; ``subset``: the name
        of a registered subset shared by every job."""
        mask = None
        if subset is not None:
            mask = self.subsets.get(subset)
            if mask is None:
                raise KeyError(f"unknown subset {subset!r} — define it "
                               f"first ({{'define_subset': ...}})")
        ks = [k for _, k in jobs]
        k_run = self.warm_k if max(ks) <= self.warm_k else max(ks)
        batch = (jobs[0][0] if len(jobs) == 1
                 else np.concatenate([v for v, _ in jobs]))
        b = batch.shape[0]
        bucket = next((x for x in self.buckets if x >= b), b)
        COUNTERS.add("vector_queries_served", b)
        t0 = time.perf_counter()
        qb = (batch if bucket == b else np.concatenate(
            [batch, np.zeros((bucket - b, batch.shape[1]), np.float32)]))
        scores, ids = self._search(qb, k_run, mask=mask)
        latency = round((time.perf_counter() - t0) * 1e3, 3)
        out, pos = [], 0
        for vecs, req_k in jobs:
            n = vecs.shape[0]
            s, i = scores[pos:pos + n], ids[pos:pos + n]
            pos += n
            results = [[{"rank": r, "id": int(ii), "score": float(ss)}
                        for r, (ss, ii) in enumerate(zip(srow[:req_k],
                                                         irow[:req_k]))
                        if ii >= 0 and np.isfinite(ss)]
                       for srow, irow in zip(s, i)]
            out.append({"results": results, "latency_ms": latency,
                        "batch_rows": int(b)})
        return out

    def handle_line(self, line: str) -> dict:
        """Parse -> decode -> device on the caller's thread; a bad request
        is answered with an error line."""
        try:
            req = json.loads(line)
            if _is_mutation(req):
                return self.mutate(req)
            vecs, req_k = self.decode(req)
            return self.run_queries([(vecs, req_k)],
                                    subset=req.get("subset"))[0]
        except Exception as e:    # noqa: BLE001 — the transport boundary
            return {"error": f"{type(e).__name__}: {e}"}


def serve_tcp(core, host: str = "127.0.0.1", port: int = 0,
              batch_wait_ms: float = 2.0,
              ready_cb: Optional[Callable[[int], None]] = None,
              stop_event: Optional[threading.Event] = None) -> int:
    """Blocking TCP JSON-lines server with cross-client micro-batching over
    ``core`` (a ``ServeCore`` or ``VectorServeCore``).

    ``port=0`` binds an ephemeral port; ``ready_cb(actual_port)`` fires
    after warm-up, once the listener accepts connections. ``stop_event``
    shuts the server down cleanly; without one the call blocks until the
    process is signalled. Returns 0.

    Batching policy: the dispatcher takes the oldest queued query, then
    keeps draining compatible query jobs until (a) the queue momentarily
    empties AND ``batch_wait_ms`` has passed since the first job was
    queued, (b) the rows reach ``core.query_cap()``, or (c) a mutation or a
    job under another subset arrives (it runs right after the batch,
    preserving global order).
    """
    stop = stop_event or threading.Event()
    q: "queue.Queue[_Job]" = queue.Queue()
    cap = core.query_cap()

    def dispatcher():
        pending: Optional[_Job] = None
        while not stop.is_set():
            job = pending
            pending = None
            if job is None:
                try:
                    job = q.get(timeout=0.05)
                except queue.Empty:
                    continue
            if job.kind == "mutate":
                _safe_reply(job, lambda j=job: core.mutate(j.req))
                continue
            jobs = [job]
            rows = job.images.shape[0]
            deadline = job.enqueued + batch_wait_ms / 1e3
            while rows < cap:
                tmo = deadline - time.perf_counter()
                try:
                    nxt = q.get(timeout=tmo) if tmo > 0 else q.get_nowait()
                except queue.Empty:
                    break
                if nxt.kind == "mutate" or nxt.batch_key != job.batch_key:
                    pending = nxt            # a barrier: it runs next
                    break
                jobs.append(nxt)
                rows += nxt.images.shape[0]
            try:
                responses = core.run_queries(
                    [(j.images, j.req["k"]) for j in jobs],
                    subset=job.batch_key)
            except Exception as e:         # noqa: BLE001 — answer, don't die
                err = {"error": f"{type(e).__name__}: {e}"}
                responses = [err] * len(jobs)
            for j, resp in zip(jobs, responses):
                _safe_reply(j, lambda r=resp: r)

    def _safe_reply(job: _Job, make) -> None:
        # a failing mutation or a closed connection must not stop the
        # dispatcher: errors answer on that client's line, writes to dead
        # sockets are dropped
        try:
            resp = make()
        except Exception as e:             # noqa: BLE001
            resp = {"error": f"{type(e).__name__}: {e}"}
        try:
            job.reply(resp)
        except OSError:
            pass

    def client_thread(conn: socket.socket) -> None:
        f = conn.makefile("rwb")
        wlock = threading.Lock()

        def reply(obj: dict) -> None:
            with wlock:
                f.write((json.dumps(obj) + "\n").encode())
                f.flush()

        try:
            for raw in f:
                line = raw.strip()
                if not line:
                    continue
                try:
                    req = json.loads(line)
                    if not isinstance(req, dict):
                        raise ValueError("request must be a JSON object")
                    if _is_mutation(req):
                        q.put(_Job("mutate", req, None, reply))
                    else:
                        images, req_k = core.decode(req)
                        q.put(_Job("query",
                                   {"k": req_k, "subset": req.get("subset")},
                                   images, reply))
                except Exception as e:     # noqa: BLE001
                    try:
                        reply({"error": f"{type(e).__name__}: {e}"})
                    except OSError:
                        break
        finally:
            try:
                conn.close()
            except OSError:
                pass

    core.warmup()
    srv = socket.create_server((host, port))
    srv.settimeout(0.2)
    disp = threading.Thread(target=dispatcher, daemon=True,
                            name="serve-dispatcher")
    disp.start()
    if ready_cb is not None:
        ready_cb(srv.getsockname()[1])
    try:
        while not stop.is_set():
            try:
                conn, _ = srv.accept()
            except socket.timeout:
                continue
            threading.Thread(target=client_thread, args=(conn,),
                             daemon=True, name="serve-client").start()
    finally:
        srv.close()
        stop.set()
        disp.join(timeout=5)
    return 0
