"""Serving core: bucketed request handling over JSON lines (port of
``instsearch_tpu/serve.py``: ``serve_buckets``, ``serve_batch`` and
``ServeCore``, query requests only, on one device or through the sharded
index).

Requests: ``{"image": PATH}`` or ``{"images": [PATH, ...]}``, optional
``"k"``. Mutations (``add``/``remove``), subsets, ``range`` and
``reconstruct`` answer with an error line saying they are not ported yet;
a bad request never raises out of ``handle_line``.

The bucket policy is kept as the reference has it: requests run through
batch sizes 1, 2, 4, 8 (split or padded up), which a later CUDA-graph
capture needs as its fixed shapes.
"""
from __future__ import annotations

import json
import time

import numpy as np


def serve_buckets(query_chunk: int) -> list[int]:
    """Warm bucket sizes: powers of two up to min(8, query_chunk)."""
    buckets = [1]
    while buckets[-1] < min(8, max(1, query_chunk or 8)):
        buckets.append(buckets[-1] * 2)
    return buckets


def serve_batch(idx, batch: np.ndarray, scfg, buckets, sidx=None):
    """Serve an image batch of any size through the bucket shapes only:
    larger requests split into largest-bucket pieces, the remainder padded
    up to the smallest covering bucket (padding rows are dropped).
    ``sidx``: the sharded index to search through, if any."""
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
        s, i = idx.query_images(piece, scfg, sharded_index=sidx)
        out_s.append(s[:take])
        out_i.append(i[:take])
        pos += take
    return np.concatenate(out_s), np.concatenate(out_i)


_NOT_PORTED_REQUESTS = {
    "add": "ROADMAP M7", "remove": "ROADMAP M7",
    "define_subset": "ROADMAP M7", "drop_subset": "ROADMAP M7",
    "subset": "ROADMAP M7", "range": "ROADMAP M7",
    "reconstruct": "ROADMAP M7",
}


class ServeCore:
    """Owns the index, the optional sharded view (``idx.to_sharded(mesh)``
    when ``sharded``) and its warm bucket shapes. ``decode`` is host-only;
    ``run_queries`` touches the device and stays on one thread."""

    def __init__(self, idx, sharded: bool = False, mesh=None):
        self.idx = idx
        self.sidx = idx.to_sharded(mesh=mesh) if sharded else None
        self.size = idx.cfg.extract.image_size
        self.warm_k = idx.cfg.search.k
        self.buckets = serve_buckets(idx.cfg.search.query_chunk)

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
    def run_queries(self, jobs: "list[tuple[np.ndarray, int]]") -> list[dict]:
        """One device pass for a list of (images, req_k) jobs. Runs at the
        warm top-k width unless a request asks for more."""
        ks = [k for _, k in jobs]
        k_run = self.warm_k if max(ks) <= self.warm_k else max(ks)
        scfg = self.idx.cfg.search.replace(k=k_run)
        batch = (jobs[0][0] if len(jobs) == 1
                 else np.concatenate([im for im, _ in jobs]))
        t0 = time.perf_counter()
        scores, ids = serve_batch(self.idx, batch, scfg, self.buckets,
                                  self.sidx)
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
            todo = sorted(set(req) & set(_NOT_PORTED_REQUESTS))
            if todo:
                raise NotImplementedError(
                    f"{', '.join(todo)} requests are not ported yet "
                    f"({_NOT_PORTED_REQUESTS[todo[0]]})")
            images, req_k = self.decode(req)
            return self.run_queries([(images, req_k)])[0]
        except Exception as e:    # noqa: BLE001 — the transport boundary
            return {"error": f"{type(e).__name__}: {e}"}
