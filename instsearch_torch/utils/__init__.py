"""Shared helpers of the port."""
from .chunking import run_chunked
from .device import resolve_device
from .observe import COUNTERS, Counters, annotate, get_logger, trace

__all__ = ["run_chunked", "resolve_device", "COUNTERS", "Counters",
           "annotate", "get_logger", "trace"]
