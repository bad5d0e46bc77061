"""Evaluation of the port: the revisited Oxford/Paris protocol
(``revisited.py``), the dataset loaders and the synthetic mini fixture
(``datasets.py``) and the literature anchors (``anchors.py``), the port's
own copies of the JAX package's numpy modules, and the protocol evaluation
of an Index (``evaluate.py``)."""
from .datasets import (RetrievalDataset, load_classic, load_dataset,
                       load_revisited, make_mini_dataset, with_distractors)
from .evaluate import build_index_for_dataset, evaluate_index, extract_queries
from .revisited import (compute_ap, evaluate_ranks, evaluate_scores,
                        precision_at)

__all__ = ["RetrievalDataset", "load_classic", "load_dataset",
           "load_revisited", "make_mini_dataset", "with_distractors",
           "build_index_for_dataset", "evaluate_index", "extract_queries",
           "compute_ap", "evaluate_ranks", "evaluate_scores",
           "precision_at"]
