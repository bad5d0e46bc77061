"""Evaluation of the port. Dataset loaders and the revisited protocol are
the reference's own numpy modules (``instsearch_tpu.eval.datasets`` and
``instsearch_tpu.eval.revisited``), which import no JAX."""
from .evaluate import evaluate_index, extract_queries

__all__ = ["evaluate_index", "extract_queries"]
