"""Evaluation of the port: the revisited Oxford/Paris protocol
(``revisited.py``), the dataset record and the synthetic mini fixture
(``datasets.py``), both the port's own copies of the JAX package's numpy
modules, and the protocol evaluation of an Index (``evaluate.py``)."""
from .datasets import RetrievalDataset, make_mini_dataset
from .evaluate import evaluate_index, extract_queries
from .revisited import evaluate_ranks

__all__ = ["RetrievalDataset", "make_mini_dataset", "evaluate_index",
           "extract_queries", "evaluate_ranks"]
