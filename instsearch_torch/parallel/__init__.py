"""Row-sharded search over a shard mesh (port of
``instsearch_tpu/parallel``: the mesh, the sharded index, the multi-process
form and the expert-parallel local whitening; the 2-D meshes and the
tp/pp/sp model-parallel paths are not ported yet)."""
from .ep import expert_whiten_fn, place_ep
from .mesh import (ShardMesh, device_mesh, make_mesh, replicate,
                   shard_rows)
from .multihost import (build_multihost_index, global_shard_mesh,
                        initialize, local_row_range, shard_local_rows)
from .sharded_index import (ShardedIndex, sharded_diffusion, sharded_expand,
                            sharded_lw, sharded_qe_topk, sharded_rerank,
                            sharded_scores, sharded_topk)

__all__ = ["ShardMesh", "device_mesh", "make_mesh", "replicate", "shard_rows",
           "ShardedIndex", "sharded_topk", "sharded_qe_topk",
           "sharded_expand", "sharded_scores", "sharded_rerank",
           "sharded_diffusion", "sharded_lw", "place_ep", "expert_whiten_fn",
           "initialize", "global_shard_mesh", "build_multihost_index",
           "local_row_range", "shard_local_rows"]
