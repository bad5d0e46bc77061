"""Image frontend of the port (host decode + device normalize)."""
from . import frontend

__all__ = ["frontend"]
