"""Search stages of the port (brute force only so far)."""
from .bruteforce import masked_scores, search_topk, select_topk

__all__ = ["masked_scores", "search_topk", "select_topk"]
