"""Shared helpers of the port."""
from .checkpoint import (load_pytree, load_sharded_pytree, save_pytree,
                         save_sharded_pytree)
from .chunking import run_chunked
from .device import resolve_device
from .observe import COUNTERS, Counters, annotate, get_logger, trace

__all__ = ["load_pytree", "save_pytree", "load_sharded_pytree",
           "save_sharded_pytree", "run_chunked", "resolve_device",
           "COUNTERS", "Counters", "annotate", "get_logger", "trace"]
