"""Shared helpers of the port."""
from .chunking import run_chunked

__all__ = ["run_chunked"]
