"""Shared helpers of the port."""
from .chunking import run_chunked
from .device import resolve_device

__all__ = ["run_chunked", "resolve_device"]
