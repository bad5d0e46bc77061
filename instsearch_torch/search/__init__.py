"""Search stages of the port: brute force and alpha query expansion."""
from .bruteforce import gather_rows_f32, masked_scores, search_topk, select_topk
from .qe import alpha_query_expansion, expand_from_candidates

__all__ = ["gather_rows_f32", "masked_scores", "search_topk", "select_topk",
           "alpha_query_expansion", "expand_from_candidates"]
