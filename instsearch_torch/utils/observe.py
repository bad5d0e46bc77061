"""Observability (port of ``instsearch_tpu/utils/observe.py``): structured
logging, counters, profiling.

- ``get_logger``: stdlib logging with a compact structured format.
- ``Counters``: process-wide metric counters; ``dump()`` returns a dict the
  CLI emits as JSON, with the reference's metric names.
- ``trace``: context manager around ``torch.profiler.profile`` writing a
  TensorBoard trace (``tensorboard_trace_handler``); ``annotate`` wraps
  ``torch.profiler.record_function`` for per-stage attribution inside it.
"""
from __future__ import annotations

import contextlib
import logging
import threading
import time
from collections import defaultdict


def get_logger(name: str = "instsearch") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter(
            "%(asctime)s %(name)s %(levelname)s %(message)s"))
        logger.addHandler(h)
        logger.setLevel(logging.INFO)
    return logger


class Counters:
    """Thread-safe counters: images extracted, queries served, etc."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counts: dict[str, float] = defaultdict(float)
        self._t0 = time.time()

    def add(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self._counts[name] += value

    def dump(self) -> dict:
        with self._lock:
            elapsed = max(time.time() - self._t0, 1e-9)
            out = dict(self._counts)
        out["elapsed_sec"] = elapsed
        if "images_extracted" in out:
            out["images_per_sec"] = out["images_extracted"] / elapsed
        if "queries_served" in out:
            out["queries_per_sec"] = out["queries_served"] / elapsed
        return out


COUNTERS = Counters()


def emit_tensorboard(logdir: str, scalars: dict | None = None,
                     step: int = 0, counters: "Counters | None" = None
                     ) -> None:
    """Write counters (and optional scalars) as TensorBoard scalars through
    tensorboardX, imported here: nested dicts flatten to slash-paths,
    non-numeric values are skipped. Raises ``ImportError`` where
    tensorboardX is not installed."""
    from tensorboardX import SummaryWriter

    def flat(prefix: str, d: dict):
        for k, v in d.items():
            key = f"{prefix}/{k}" if prefix else str(k)
            if isinstance(v, dict):
                yield from flat(key, v)
            elif isinstance(v, (int, float)) and not isinstance(v, bool):
                yield key, float(v)

    w = SummaryWriter(logdir)
    try:
        for key, v in flat("counters", (counters or COUNTERS).dump()):
            w.add_scalar(key, v, step)
        if scalars:
            for key, v in flat("bench", scalars):
                w.add_scalar(key, v, step)
    finally:
        w.close()


@contextlib.contextmanager
def trace(log_dir: str):
    """A TensorBoard profiler trace of the host and, where there is one,
    the CUDA card around a region, written to ``log_dir``."""
    import torch
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


def annotate(name: str):
    """Named sub-region inside a profiler trace."""
    from torch.profiler import record_function

    return record_function(name)
