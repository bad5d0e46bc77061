"""Search stages of the port: brute force, alpha query expansion,
regional re-ranking with spatial verification, subset filters, αDBA,
diffusion and local-whitening re-ranking, and the ANN tiers (IVF, IVF-PQ
with the host row store)."""
from .bruteforce import (all_scores, gather_rows_f32, masked_scores,
                         search_topk, select_topk)
from .dba import dba_augment
from .ivf import IVFIndex, recall_vs_exact
from .ivfpq import HostRowStore, IVFPQView
from .diffusion import (diffuse_from_candidates,
                        diffusion_rerank_from_candidates,
                        diffusion_rerank_scores)
from .lw_rerank import (LocalWhiteningView, lw_rescore_from_candidates,
                        whiten_all_clusters)
from .qe import alpha_query_expansion, expand_from_candidates
from .rerank import (region_match_scores, region_similarities,
                     regional_rerank_scores, rerank_from_candidates)
from .spatial import build_vote_matrix, spatial_consistency_scores
from .subset import SubsetFilter, build_position_mask

__all__ = ["all_scores", "gather_rows_f32", "masked_scores", "search_topk",
           "select_topk", "regional_rerank_scores",
           "alpha_query_expansion", "expand_from_candidates",
           "region_match_scores", "region_similarities",
           "rerank_from_candidates", "build_vote_matrix",
           "spatial_consistency_scores", "SubsetFilter",
           "build_position_mask", "dba_augment", "diffuse_from_candidates",
           "diffusion_rerank_from_candidates", "diffusion_rerank_scores",
           "LocalWhiteningView", "lw_rescore_from_candidates",
           "whiten_all_clusters", "IVFIndex", "recall_vs_exact",
           "IVFPQView", "HostRowStore"]
