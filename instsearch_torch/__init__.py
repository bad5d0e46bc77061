"""instsearch_torch — the PyTorch / CUDA port of instsearch for NVIDIA Hopper.

The JAX package ``instsearch_tpu`` is the reference; this package keeps its
sub-module names so each counterpart is easy to find. It imports ``torch``
and never ``jax`` or ``flax``. Its config dataclasses have the reference's
fields and JSON form, so the presets under ``configs/`` load unchanged.
"""

__version__ = "0.1.0"

from .config import (
    EvalConfig,
    ExtractConfig,
    IndexConfig,
    PipelineConfig,
    SearchConfig,
    TrainConfig,
)

__all__ = [
    "ExtractConfig", "IndexConfig", "SearchConfig", "EvalConfig",
    "TrainConfig", "PipelineConfig", "Index", "__version__",
]


def __getattr__(name):
    # lazy, as in the reference: a bare import stays cheap
    if name == "Index":
        from .index import Index
        return Index
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
