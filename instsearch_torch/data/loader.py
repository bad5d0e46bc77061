"""Prefetching input pipeline (port of ``instsearch_tpu/data/loader.py``):
decode on the host while the card computes.

``PrefetchLoader`` runs ``frontend.batch_paths`` (the native C++ threaded
decoder where it builds) in a background thread: batch i+depth decodes
while the card runs batch i. With ``device_put`` the producer thread also
uploads each batch to the device, from a pinned host buffer with
``non_blocking=True`` on a copy stream of its own, so the copy of batch
i+1 overlaps the compute and readback of batch i.

``grain_dataset`` is the reference's ``grain`` pipeline (decode -> batch)
without ``grain``: a map-style ``torch.utils.data.Dataset`` decoding through
``frontend.load_square``, batched by a ``DataLoader``.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator, Sequence

import numpy as np
import torch

from ..utils.device import resolve_device
from . import frontend


class PrefetchLoader:
    """Iterate (uint8 [B,S,S,3], indices [B]) with background prefetch.

    ``device_put=True`` yields each batch as a uint8 tensor on ``device``
    (the CUDA card by default, raising without one), uploaded from the
    producer thread; otherwise the numpy batch."""

    def __init__(self, paths: Sequence[str], size: int, batch: int,
                 depth: int = 2, quarantine: list | None = None,
                 device_put: bool = False,
                 *, device: "torch.device | str | None" = None):
        self.paths = paths
        self.size = size
        self.batch = batch
        self.depth = depth
        self.quarantine = quarantine
        self.device_put = device_put
        self.device = resolve_device(device) if device_put else None

    def _upload(self, batch: np.ndarray, copy_stream, consumer_stream
                ) -> torch.Tensor:
        """``batch`` on the device: on the card, a pinned host copy sent on
        ``copy_stream`` (so it overlaps the compute on the consumer's
        stream), waited for here, and the tensor's memory kept from reuse
        until ``consumer_stream`` is done with it."""
        host = torch.from_numpy(batch)
        if copy_stream is None:
            return host.to(self.device)
        with torch.cuda.stream(copy_stream):
            out = host.pin_memory().to(self.device, non_blocking=True)
        copy_stream.synchronize()
        out.record_stream(consumer_stream)
        return out

    def __iter__(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        copy_stream = consumer_stream = None
        if self.device_put and self.device.type == "cuda":
            copy_stream = torch.cuda.Stream(self.device)
            consumer_stream = torch.cuda.current_stream(self.device)
        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        DONE = object()
        err: list[BaseException] = []
        stop = threading.Event()

        def put(item) -> bool:
            # a bounded put that gives up when the consumer went away, so an
            # abandoned iteration does not leave this thread blocked forever
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for batch, idxs in frontend.batch_paths(
                        self.paths, self.size, self.batch, self.quarantine):
                    if self.device_put:
                        batch = self._upload(batch, copy_stream,
                                             consumer_stream)
                    if not put((batch, idxs)):
                        return
            except BaseException as e:  # surfaced on the consumer side
                err.append(e)
            finally:
                put(DONE)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        completed = False
        try:
            while True:
                item = q.get()
                if item is DONE:
                    break
                yield item
            completed = True
        finally:
            stop.set()               # unblock the producer on early exit
            while True:              # drain so its pending put() returns
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            t.join()
            if completed and err:    # abandoned iteration: swallow, the
                raise err[0]         # consumer already moved on


def iter_batches(paths: Sequence[str], size: int, batch: int,
                 quarantine: list | None = None, depth: int = 2,
                 device_put: bool = False,
                 *, device: "torch.device | str | None" = None):
    """The input pipeline of every path-based extraction: prefetched decode
    batches, or the synchronous iterator of numpy batches when the paths fit
    in one batch (thread start-up would dominate). Batches from the loader
    are tensors on ``device`` with ``device_put``, else numpy."""
    if len(paths) <= batch:
        return frontend.batch_paths(paths, size, batch, quarantine)
    return iter(PrefetchLoader(paths, size, batch, depth=depth,
                               quarantine=quarantine, device_put=device_put,
                               device=device))


class _DecodeDataset(torch.utils.data.Dataset):
    """Item i: ``(uint8 [S, S, 3], i)``, or a zero image and -1 where the
    decode fails (a map stage cannot drop an element)."""

    def __init__(self, paths: Sequence[str], size: int):
        self.paths, self.size = list(paths), size

    def __len__(self) -> int:
        return len(self.paths)

    def __getitem__(self, i: int):
        img = frontend.load_square(self.paths[i], self.size)
        if img is None:
            return np.zeros((self.size, self.size, 3), np.uint8), np.int64(-1)
        return img, np.int64(i)


def _stack(items):
    return (np.stack([img for img, _ in items]),
            np.asarray([i for _, i in items], np.int64))


def grain_dataset(paths: Sequence[str], size: int, batch: int,
                  num_workers: int = 0):
    """The reference's decode -> batch pipeline: iterating it yields
    ``(images uint8 [B, S, S, 3], idx int64 [B])`` numpy batches in path
    order, the last one partial. Failed decodes yield zero images with
    index -1 (callers filter). ``num_workers`` > 0 decodes in that many
    worker processes."""
    return torch.utils.data.DataLoader(
        _DecodeDataset(paths, size), batch_size=batch, shuffle=False,
        drop_last=False, num_workers=num_workers, collate_fn=_stack)
